"""Pipeline parallelism as an STF task graph — the port of
``repro.runtime.pipeline``.

GPipe-style microbatch pipelining is *exactly* the paper's model: stage
executions are tasks, activations are the data dependencies, gradient
accumulation across microbatches is commutative, and the schedule (GPipe
fill-drain vs 1F1B) is nothing but the scheduler's choice among ready tasks
— expressed here with per-call priorities so the standard priority
scheduler produces a 1F1B-flavoured order, while FIFO degrades to
fill-drain.  The task shapes (forward, loss-head, backward, first-stage
backward) are declared once as codelets and instantiated per (stage,
microbatch).

Task structure for S stages × M microbatches::

    F[s,m]:  SpRead(params_s), SpRead(act[s-1,m])
             → SpWrite(act[s,m]), SpWrite(vjp[s,m])
    L[m]:    SpRead(params_head), SpRead(act[S-1,m])
             → SpWrite(dact[S-1,m]), SpCommutativeWrite(grads_head, loss)
    B[s,m]:  SpRead(vjp[s,m]), SpRead(dact[s,m])
             → SpWrite(dact[s-1,m]), SpCommutativeWrite(grads_s)

Where ``repro`` keeps ``jax.vjp``'s pull-back, ``F`` records autograd: it
runs ``stage_fn`` on a detached, ``requires_grad`` copy of its input with
the stage's parameters as leaves, and keeps the output, the leaves and the
input in ``vjp[s][m]``; ``B`` pulls with ``torch.autograd.grad(y, (leaves…,
x), dy)`` (which frees the recorded activations) and adds into the
stage's float32 gradient cell in place.  Parameters are a tensor, a dict
of them (nested), or ``nn.Module``s (a module's parameters that require
gradients are its leaves; plain tensors are differentiated through
``requires_grad`` aliases, so the caller's tensors are never touched).
The gradients come back in the same structure, a module as the dict of
its trainable ``named_parameters``.

Stages are worker threads of one engine and the hand-offs are the SpData
cells.  On the card every worker launches on the same (default) stream and
a task starts only after the tasks it depends on have returned, so each
hand-off's kernels are queued after the kernels that produced it; the
autograd Functions of the kernels (flash, rmsnorm, ssd) keep no state
between calls, so several threads may record and pull at once.  The
schedule's bubble is measured by ``trace_metrics`` (one minus its
utilization).
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
from torch import nn

from repro_torch.core import SpComputeEngine, SpData, SpTaskGraph, graph_scope, sp_task
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import chunked_softmax_xent, embed_apply, logits_apply, softmax_xent
from repro_torch.models.transformer import _remat, layer_cfg


# ---------------------------------------------------------------------------
# Parameter trees: leaves to differentiate, and the gradient cells.
# ---------------------------------------------------------------------------

def _grad_view(params):
    """(what ``stage_fn`` is given, the leaves autograd differentiates):
    tensors become ``requires_grad`` aliases, modules stay as they are."""
    leaves: list = []

    def walk(p):
        if isinstance(p, nn.Module):
            leaves.extend(t for t in p.parameters() if t.requires_grad)
            return p
        if isinstance(p, dict):
            return {k: walk(v) for k, v in p.items()}
        alias = p.detach().requires_grad_(True)
        leaves.append(alias)
        return alias

    return walk(params), leaves


def _zero_grads(params):
    """Float32 zeros in ``params``' structure (a module: its trainable
    ``named_parameters``), in the order of ``_grad_view``'s leaves."""
    if isinstance(params, nn.Module):
        return {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                for n, t in params.named_parameters() if t.requires_grad}
    if isinstance(params, dict):
        return {k: _zero_grads(v) for k, v in params.items()}
    return torch.zeros(params.shape, dtype=torch.float32, device=params.device)


def _flat(grads) -> list:
    if isinstance(grads, dict):
        return [t for v in grads.values() for t in _flat(v)]
    return [grads]


@torch.no_grad()
def _accumulate(grads, gs) -> None:
    for acc, g in zip(_flat(grads), gs):
        if g is not None:
            acc.add_(g)


def _input(x):
    """A detached, ``requires_grad`` copy of a floating activation; token
    ids (the first stage's input) are used as they are."""
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.detach().requires_grad_(True)
    return x


# ---------------------------------------------------------------------------
# The task shapes, declared once (codelet frontend, core/api.py).
# ---------------------------------------------------------------------------

@sp_task(read=("params", "x"), write=("act", "vjp"), name="F", cost=5.0)
def _forward(params, x, act, vjp, *, stage_fn, first):
    x_val = x["x"] if first and isinstance(x, dict) else x
    x_in = _input(x_val)
    p_view, leaves = _grad_view(params)
    with torch.enable_grad():
        y = stage_fn(p_view, x_in)
    act.value = y.detach()
    vjp.value = (y, leaves, x_in if isinstance(x_in, torch.Tensor) and x_in.requires_grad else None)


@sp_task(
    read=("params", "x", "mb"),
    write=("dact",),
    commutative=("grads", "loss"),
    name="L",
    cost=2.0,
)
def _loss_head(params, x, mb, dact, grads, loss, *, head_fn, inv_m):
    x_in = _input(x)
    p_view, leaves = _grad_view(params)
    with torch.enable_grad():
        loss_val = head_fn(p_view, x_in, mb)
        *gp, gx = torch.autograd.grad(loss_val, (*leaves, x_in), torch.full_like(loss_val, inv_m),
                                      allow_unused=True)
    dact.value = gx
    _accumulate(grads.value, gp)
    loss.value = loss.value + loss_val.detach().float() * inv_m


def _pull(pull, dy, with_input: bool):
    y, leaves, x_in = pull
    inputs = (*leaves, x_in) if with_input else tuple(leaves)
    return torch.autograd.grad(y, inputs, dy, allow_unused=True)


@sp_task(read=("pull", "dy"), commutative=("grads",), write=("dact",), name="B", cost=8.0)
def _backward(pull, dy, grads, dact):
    *gp, gx = _pull(pull, dy, True)
    _accumulate(grads.value, gp)
    dact.value = gx


@sp_task(read=("pull", "dy"), commutative=("grads",), name="B0", cost=8.0)
def _backward_first(pull, dy, grads):
    _accumulate(grads.value, _pull(pull, dy, False))


def pipeline_value_and_grad(
    stage_fns: Sequence[Callable],
    head_fn: Callable,
    stage_params: Sequence[Any],
    head_params: Any,
    microbatches: Sequence[Any],
    engine: SpComputeEngine,
    *,
    schedule: str = "1f1b",
) -> tuple[torch.Tensor, list, Any, SpTaskGraph]:
    """Run a pipelined forward+backward over ``microbatches``.

    stage_fns[s](params_s, x) -> x';  head_fn(params_h, x, mb) -> scalar loss.
    The first stage is given ``mb["x"]`` when a microbatch is a dict.
    Returns (mean loss, per-stage grads, head grads, the graph — for
    trace_metrics / exports); gradients are float32.
    """
    if schedule not in ("1f1b", "fifo"):
        raise ValueError(f"unknown schedule {schedule!r}; use '1f1b' or 'fifo'")
    S, M = len(stage_fns), len(microbatches)
    tg = SpTaskGraph().compute_on(engine)

    p_cells = [SpData(p, f"stage{s}.params") for s, p in enumerate(stage_params)]
    ph_cell = SpData(head_params, "head.params")
    act = [[SpData(None, f"act[{s}][{m}]") for m in range(M)] for s in range(S)]
    vjp = [[SpData(None, f"vjp[{s}][{m}]") for m in range(M)] for s in range(S)]
    dact = [[SpData(None, f"dact[{s}][{m}]") for m in range(M)] for s in range(S)]
    g_cells = [SpData(_zero_grads(p), f"grads{s}") for s, p in enumerate(stage_params)]
    gh_cell = SpData(_zero_grads(head_params), "grads.head")
    # a CPU scalar: the first L task's sum lands on the loss's own device
    loss_cell = SpData(torch.zeros((), dtype=torch.float32), "loss")
    mb_cells = [SpData(mb, f"mb{m}") for m, mb in enumerate(microbatches)]

    def prio(kind: str, s: int, m: int) -> int:
        if schedule == "1f1b":
            # backward beats forward; earlier microbatches beat later; deeper
            # stages first for backward (drain), shallower first for forward
            base = 10_000 if kind == "b" else 0
            return base + (M - m) * 100 + (s if kind == "b" else S - s)
        return 0  # fifo / fill-drain

    with graph_scope(tg):
        for m in range(M):
            # ---- forward tasks ------------------------------------------------
            for s in range(S):
                src = mb_cells[m] if s == 0 else act[s - 1][m]
                _forward(
                    p_cells[s], src, act[s][m], vjp[s][m],
                    stage_fn=stage_fns[s], first=(s == 0),
                    name=f"F[{s},{m}]", priority=prio("f", s, m),
                )

            # ---- loss head + seed backward ------------------------------------
            _loss_head(
                ph_cell, act[S - 1][m], mb_cells[m],
                dact[S - 1][m], gh_cell, loss_cell,
                head_fn=head_fn, inv_m=1.0 / M,
                name=f"L[{m}]", priority=prio("b", S - 1, m) + 1,
            )

            # ---- backward tasks -----------------------------------------------
            for s in range(S - 1, -1, -1):
                if s > 0:
                    _backward(
                        vjp[s][m], dact[s][m], g_cells[s], dact[s - 1][m],
                        name=f"B[{s},{m}]", priority=prio("b", s, m),
                    )
                else:
                    _backward_first(
                        vjp[0][m], dact[0][m], g_cells[0],
                        name=f"B[0,{m}]", priority=prio("b", 0, m),
                    )

    tg.wait_all_tasks()
    out = loss_cell.value, [g.value for g in g_cells], gh_cell.value, tg
    # the engine keeps every graph it has driven (its stop report reads
    # them), and the graph keeps its cells: leave it empty cells, so the
    # activations, pull-backs and gradients live only as long as the caller
    # holds them
    for cell in (*p_cells, ph_cell, gh_cell, loss_cell, *g_cells, *mb_cells,
                 *(c for rows in (act, vjp, dact) for row in rows for c in row)):
        cell.value = None
    return out


def split_stages(params_layers: Any, n_stages: int, n_layers: int):
    """Slice layers into ``n_stages`` contiguous chunks: a stacked dict of
    tensors (layer axis 0) into dicts of slices, or a sequence of per-layer
    modules (an ``nn.ModuleList``) into ``nn.ModuleList``s."""
    per = n_layers // n_stages
    if per * n_stages != n_layers:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} equal stages")
    if isinstance(params_layers, dict):
        parts = {k: [v[s * per:(s + 1) * per] for s in range(n_stages)] if isinstance(v, torch.Tensor)
                 else split_stages(v, n_stages, n_layers) for k, v in params_layers.items()}
        return [{k: p[s] for k, p in parts.items()} for s in range(n_stages)]
    layers = list(params_layers)
    if len(layers) != n_layers:
        raise ValueError(f"{len(layers)} layers given, {n_layers} expected")
    return [nn.ModuleList(layers[s * per:(s + 1) * per]) for s in range(n_stages)]


def model_stages(model: nn.Module, cfg: ArchConfig, n_stages: int):
    """A :class:`~repro_torch.models.transformer.Transformer` as pipeline
    stages: → (stage_fns, stage_params, head_fn, head_params).  Stage 0
    holds the embedding and the first layers, each later stage its
    contiguous layers (:func:`split_stages`); the head holds the final
    norm and the logits weights and computes ``loss_fn``'s cross-entropy
    (chunked when ``cfg.logits_chunk`` is set) against ``mb["labels"]``.
    The stages' modules share the model's parameters.  With tied
    embeddings the embedding sits in stage 0 and in the head, and its
    gradient is the sum of the two.  A MoE model's aux losses have no
    place in a stage's output: it raises."""
    if cfg.family == "moe":
        raise ValueError("model_stages: a MoE model's aux losses do not pass between stages")
    lcfg, causal = layer_cfg(cfg), not cfg.is_encoder
    stages = []
    for s, chunk in enumerate(split_stages(model.layers, n_stages, cfg.n_layers)):
        stage = nn.Module()
        if s == 0:
            stage.embedding = model.embedding
        stage.layers = chunk
        stages.append(stage)
    head = nn.Module()
    head.final_norm = model.final_norm
    for name in ("unembed",) if getattr(model, "unembed", None) is not None else ("embedding",):
        setattr(head, name, getattr(model, name))

    def stage_fn(p, x):
        if not x.is_floating_point():
            x = embed_apply(p, x, cfg)
        B, L = x.shape[:2]
        positions = torch.arange(L, dtype=torch.int32, device=x.device).expand(B, L)
        for layer in p.layers:
            x, _, _ = _remat(layer, cfg)(x, positions, lcfg, causal=causal, want_cache=False)
        return x

    def head_fn(p, x, mb):
        x = p.final_norm(x)
        if cfg.logits_chunk:
            return chunked_softmax_xent(x, mb["labels"], p, cfg, mb.get("mask"), chunk=cfg.logits_chunk)
        return softmax_xent(logits_apply(p, x, cfg), mb["labels"], mb.get("mask"))

    return [stage_fn] * n_stages, stages, head_fn, head


def named_grads(g_stages: Sequence[dict], g_head: dict, n_layers: int) -> dict:
    """:func:`model_stages`' gradients under the model's own parameter
    names (stage ``s``'s ``layers.i.…`` is the model's ``layers.{s·per +
    i}.…``); a parameter held by two stages (tied embeddings) gets the sum."""
    per = n_layers // len(g_stages)
    out: dict = {}
    for s, g in enumerate(g_stages):
        for n, t in g.items():
            if n.startswith("layers."):
                _, i, rest = n.split(".", 2)
                n = f"layers.{s * per + int(i)}.{rest}"
            out[n] = t
    for n, t in g_head.items():
        out[n] = out[n] + t if n in out else t
    return out
