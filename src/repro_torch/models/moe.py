"""Mixture-of-Experts layer — qwen3-moe-235b-a22b, llama4-scout.

A port of ``repro.models.moe``.  The router runs in float32 (its
parameter is float32) and returns the aux losses (load balance and router
z-loss) for the trainer.  Two dispatches:

* ``einsum`` (the configs' default) — GShard capacity dispatch with a
  per-group capacity C; the k = 0 choice of every token claims capacity
  before any k = 1 choice.  Tokens beyond an expert's capacity are
  dropped.  Dispatch and combine both go through each choice's slot (see
  :func:`_einsum_moe`): a token's output does not depend on the others in
  its group while none is dropped, so a decode step's tokens do not depend
  on the batch.
* ``scatter`` — sort-based: the (token, choice) pairs sorted stably by
  expert (``torch.argsort(stable=True)``, as ``jnp.argsort`` is) give each
  choice its slot; the kept ones are added into per-expert capacity
  buffers (``index_add``), the expert FFNs run on the packed (E, C, D)
  buffer and the results are added back per token.  On the card
  ``index_add`` adds in no fixed order, and the combine gives each token
  ``top_k`` adds, so its float sums (in the model dtype) can differ in the
  last bits from run to run; the einsum dispatch has no such adds.

``repro`` computes both in jnp outside any Pallas kernel, so the port does
it with torch ops.  ``torch.topk`` and ``jax.lax.top_k`` order ties
differently; router probabilities from continuous inputs do not tie.

On a ``model`` mesh axis of m > 1 (``MoE.tp``) the layer runs as
``repro``'s ``safe_spec`` lays its weights out: with m dividing E the
``experts`` axis is sharded (expert parallelism: rank r holds experts
[r·E/m, (r+1)·E/m)), else, with m dividing the expert width, ``expert_ff``
(each expert column / row parallel, as the dense MLP).  Either way:

* the router (float32, replicated), top-k, the aux losses, the capacity
  and every choice's slot are computed on every rank from the replicated
  input, outside the sharded region, so the router's and the aux losses'
  gradients are whole on every rank and counted once.  Every rank makes
  the same choices: its inputs and operations are the same bits;
* the input enters the region through ``copy_to_model`` and so do the
  combine weights (the renormalised top-k probabilities): each rank's
  part of the combine gives a part of their gradient, which the backward
  sums over ``model``;
* each rank dispatches only into its experts' slots (under ``expert_ff``:
  every expert's), runs its part of the expert FFNs and combines only its
  choices into a float32 partial output, which ``reduce_from_model`` sums.

The shared expert (llama4-scout) is the tensor-parallel ``MLP``.  Off a
``model`` axis the region is the whole layer and nothing is summed.

On the batch axes (``pod`` × ``data``) the routing keeps the global
semantics GSPMD gives ``repro`` where a step's rows are split over ranks,
as the step declares (``dist.sharding.split_rows``: the train step, the
serve step and the dry run do; ``moe_apply``'s ``rows``): the dispatch's
groups (einsum: ``min(4096, global tokens)`` of the flattened global
batch; scatter: all of them) and their capacity are the global batch's,
so where a group spans ranks each rank all-gathers its ``top_i`` over the
split's axes, slots every choice of the group and dispatches its own
tokens into buffers of the global capacity; and the load-balance loss
multiplies the global means of the router probabilities and of the first
choices (:func:`_over_batch`).  The z-loss, a mean of per-token terms, is
the ranks' mean as the step averages it.  Rows that are not split (the
batch axes replicate them, or no split is declared) are the whole batch
on every rank and route alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.collectives import copy_to_model, model_all_gather, model_sum_, reduce_from_model
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import MLP, make_params, mlp_defs, sharded_axis
from repro_torch.models.param import ParamDef


def moe_defs(cfg: ArchConfig) -> dict:
    m = cfg.moe
    D, Fe, E = cfg.d_model, m.d_ff_expert, m.n_experts
    defs = {
        "router": ParamDef((D, E), ("embed", None), dtype="float32"),
        "wi_gate": ParamDef((E, D, Fe), ("experts", "embed", "expert_ff")),
        "wi_up": ParamDef((E, D, Fe), ("experts", "embed", "expert_ff")),
        "wo": ParamDef((E, Fe, D), ("experts", "expert_ff", "embed")),
    }
    if m.n_shared_experts:
        defs["shared"] = mlp_defs(D, Fe * m.n_shared_experts, cfg.act)
    return defs


class MoE(nn.Module):
    """The routed experts' weights (this rank's part on a ``model`` axis)
    and the shared expert.  ``tp`` is the ``model`` axis when it shards the
    experts (``ep``) or their width, else None."""

    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype, device):
        super().__init__()
        defs = moe_defs(cfg)
        defs.pop("shared", None)
        make_params(self, defs, dtype=dtype, device=device)
        ep = sharded_axis(defs["wi_gate"], 0)
        self.ep = ep is not None
        self.tp = ep or sharded_axis(defs["wi_gate"], 2)
        m = cfg.moe
        if m.n_shared_experts:
            self.shared = MLP(cfg, dtype=dtype, device=device,
                              d_ff=m.d_ff_expert * m.n_shared_experts)


def capacity(tokens_per_group: int, cfg: ArchConfig) -> int:
    """Slots per expert: capacity_factor · tokens · top_k / E, rounded up to
    a multiple of 8, at least 8."""
    m = cfg.moe
    c = int(m.capacity_factor * tokens_per_group * m.top_k / m.n_experts)
    return max(8, -(-c // 8) * 8)


def _batch_ranks(rows) -> int:
    return 1 if rows is None else rows.size


class _BatchMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups, n):
        t = t.contiguous().clone()
        for g in groups:
            model_sum_(t, g)
        return t.div_(n)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _over_batch(rows, t: torch.Tensor) -> torch.Tensor:
    """A per-rank mean over tokens → the mean over every rank's tokens of
    the batch axes (each rank holds as many), its gradient passed through
    as it is: rank r's loss holds the global mean m = Σ m_r / n, whose
    gradient is Σ_r ∂m_r / n; the train step's mean of the ranks' gradients
    gives it from each rank's ∂m_r (module docstring)."""
    if rows is None:
        return t
    return _BatchMean.apply(t, rows.groups, rows.size)


def _gather_rows(rows, t: torch.Tensor) -> torch.Tensor:
    """This rank's token rows (T, ...) → every rank's over the batch axes,
    in the global batch's order (untracked)."""
    for g in reversed(rows.groups):  # the minor axis first
        t = torch.cat(list(model_all_gather(t, g).unbind(0)), dim=0)
    return t


def _router(p: MoE, xt: torch.Tensor, cfg: ArchConfig, rows=None, want_aux: bool = True):
    """xt (..., D) → (top-k probs renormalised, top-k experts, aux losses |
    None without ``want_aux``); the load-balance loss's means are over the
    tokens of every rank of the split ``rows`` (module docstring)."""
    m = cfg.moe
    logits = xt.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, m.top_k, dim=-1)
    top_p = top_p / torch.clamp(torch.sum(top_p, dim=-1, keepdim=True), min=1e-9)
    if not want_aux:
        return top_p, top_i, None
    E = m.n_experts
    lead = tuple(range(probs.ndim - 1))
    me = torch.mean(probs, dim=lead)  # mean probability per expert
    ce = torch.mean(F.one_hot(top_i[..., 0], E).float(), dim=lead)
    me, ce = _over_batch(rows, me), _over_batch(rows, ce)
    balance = E * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return top_p, top_i, {"moe_balance": balance, "moe_zloss": z}


def _expert_ffn(p: MoE, t: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """t (..., E, C, D) → (..., E, C, D): each expert's gated MLP."""
    g = torch.einsum("...ecd,edf->...ecf", t, p.wi_gate)
    u = torch.einsum("...ecd,edf->...ecf", t, p.wi_up)
    g = F.silu(g) if cfg.act == "swiglu" else F.gelu(g, approximate="tanh")
    return torch.einsum("...ecf,efd->...ecd", g * u, p.wo)


def _local_experts(p: MoE, cfg: ArchConfig) -> tuple[int, int]:
    """(first expert, number of experts) this rank holds: its block of
    experts under expert parallelism, every expert otherwise."""
    E = cfg.moe.n_experts
    if not p.ep:
        return 0, E
    n = E // p.tp.size
    return p.tp.rank * n, n


def _enter_region(p: MoE, x: torch.Tensor, top_p: torch.Tensor):
    """The dispatch's input and the combine weights as the sharded region
    takes them: through ``copy_to_model`` (their gradients summed over
    ``model``) when the layer is sharded."""
    if p.tp is None:
        return x, top_p
    return copy_to_model(x, p.tp.group), copy_to_model(top_p, p.tp.group)


def _leave_region(p: MoE, y: torch.Tensor) -> torch.Tensor:
    """A rank's partial output summed over ``model`` (sharded layer)."""
    return y if p.tp is None else reduce_from_model(y, p.tp.group)


def _einsum_slots(top_i: torch.Tensor, C: int, E: int) -> tuple[torch.Tensor, torch.Tensor]:
    """top_i (G, S, K) → (each choice's slot e·C + position, kept): the
    position counts the expert's earlier choices in the group, every token's
    k = 0 choice before any k = 1 choice (GShard priority)."""
    G, S, K = top_i.shape
    acc_counts = torch.zeros((G, E), dtype=torch.float32, device=top_i.device)
    slot_of, kept = [], []
    for k in range(K):
        ohk = F.one_hot(top_i[..., k], E).float()  # (G, S, E)
        pos = torch.cumsum(ohk, dim=1) - ohk + acc_counts[:, None, :]
        acc_counts = acc_counts + torch.sum(ohk, dim=1)
        pos_of = torch.sum(pos * ohk, dim=-1)  # (G, S)
        slot_of.append(top_i[..., k] * C + torch.clamp(pos_of, max=C - 1).long())
        kept.append(pos_of < C)
    return torch.stack(slot_of, dim=-1), torch.stack(kept, dim=-1)


def _einsum_moe(p: MoE, xt: torch.Tensor, cfg: ArchConfig, rows=None, want_aux: bool = True):
    """xt (T, D) this rank's tokens, in groups of ``min(4096, global
    tokens)`` of the global batch (``repro``'s), capacity per group.  Each
    choice's slot is ``repro``'s (:func:`_einsum_slots`); a group that
    spans the batch axes' ranks takes its choices from every rank (one
    all-gather of ``top_i``).  The dispatch writes each kept choice's token
    into its slot, which is what ``repro``'s one-hot (G, S, E, C) einsum
    gives exactly, each slot holding one token.  The combine gathers each
    token's top_k slot outputs and adds them in choice order, where
    ``repro`` contracts a (G, S, E, C) combine tensor over (E, C): the same
    sum, but an einsum would add a token's terms at positions that move
    with its capacity slot, which the other tokens' choices set, so a
    token's output would depend on its batch.  On a ``model`` axis only
    this rank's experts' slots are filled and combined (module docstring);
    their float32 sum over ``model`` is the output."""
    m = cfg.moe
    T, D = xt.shape
    E, K = m.n_experts, m.top_k
    g = min(4096, T * _batch_ranks(rows))
    C = capacity(g, cfg)
    top_p, top_i, aux = _router(p, xt, cfg, rows, want_aux)  # (T, K)
    if T % g == 0:  # this rank's rows hold whole groups
        G = T // g
        idx, keep = _einsum_slots(top_i.reshape(G, g, K), C, E)
    elif g % T == 0:  # they lie in one group with other ranks' rows
        G, first = 1, rows.rank * T
        start = first - first % g
        idx, keep = _einsum_slots(_gather_rows(rows, top_i)[None, start:start + g], C, E)
        idx, keep = idx[:, first - start:first - start + T], keep[:, first - start:first - start + T]
    else:
        raise NotImplementedError(f"{T} tokens a rank do not tile the dispatch's groups of {g}")
    x_in, top_p = _enter_region(p, xt.reshape(G, T // G, D), top_p.reshape(G, T // G, K))
    lo, n = _local_experts(p, cfg)
    idx = idx - lo * C  # each choice's slot among this rank's
    keep = keep & (idx >= 0) & (idx < n * C)
    rows = torch.arange(G, device=xt.device)[:, None, None]
    # a dropped (or another rank's) choice writes to a spare row n·C, cut off after
    ein = x_in.new_zeros((G, n * C + 1, D)).index_put(
        (rows, torch.where(keep, idx, n * C)), x_in[:, :, None, :].expand(G, T // G, K, D))
    h = _expert_ffn(p, ein[:, :n * C].reshape(G, n, C, D), cfg).reshape(G, n * C, D)
    w = top_p * keep  # a dropped choice adds nothing
    picked = h[rows, idx.clamp(0, n * C - 1)].float()  # (G, S, K, D)
    y = _leave_region(p, torch.sum(picked * w[..., None], dim=2))
    return y.to(xt.dtype).reshape(T, D), aux


def _scatter_moe(p: MoE, xt: torch.Tensor, cfg: ArchConfig, rows=None, want_aux: bool = True):
    """xt (T, D) this rank's tokens; the capacity is over the global
    batch's tokens, as one flat group (``repro``'s): every rank's choices
    (one all-gather of ``top_i`` over the batch axes) sorted stably by
    expert, each choice's slot its place among its expert's, and this
    rank's kept choices added into per-expert buffers of the global
    capacity.  The counts per expert are a ``scatter_add`` of ones
    (``bincount``'s result, at a shape that does not depend on the data, so
    the dry run's ``meta`` tensors take it).  On a ``model`` axis only this
    rank's experts' choices are dispatched and combined, into a float32
    partial output summed over ``model`` (module docstring)."""
    m = cfg.moe
    T, D = xt.shape
    E, K = m.n_experts, m.top_k
    n_ranks = _batch_ranks(rows)
    C = capacity(T * n_ranks, cfg)
    top_p, top_i, aux = _router(p, xt, cfg, rows, want_aux)  # (T, K)
    x_in, top_p = _enter_region(p, xt, top_p)
    flat_e = (top_i if n_ranks == 1 else _gather_rows(rows, top_i)).reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = torch.zeros(E, dtype=se.dtype, device=se.device).scatter_add_(0, se, torch.ones_like(se))
    offsets = torch.cumsum(counts, dim=0) - counts
    in_order = torch.arange(flat_e.numel(), device=xt.device) - offsets[se]
    first = 0 if n_ranks == 1 else rows.rank * T
    slot = torch.empty_like(in_order).scatter_(0, order, in_order)[first * K:(first + T) * K]  # token-major
    e = top_i.reshape(-1)
    lo, n = _local_experts(p, cfg)
    keep = (slot < C) & (e >= lo) & (e < lo + n)
    # a dropped (or another rank's) choice adds into a spare row n·C, cut off after
    dest = torch.where(keep, (e - lo) * C + torch.clamp(slot, 0, C - 1), n * C)
    token = torch.arange(T * K, device=xt.device) // K
    gathered = x_in[token] * keep[:, None].to(xt.dtype)
    buf = torch.zeros((n * C + 1, D), dtype=xt.dtype, device=xt.device).index_add(0, dest, gathered)
    h = _expert_ffn(p, buf[:n * C].reshape(n, C, D), cfg).reshape(n * C, D)
    contrib = h[dest.clamp(max=n * C - 1)] * (top_p.reshape(-1) * keep)[:, None].to(h.dtype)
    acc = xt.dtype if p.tp is None else torch.float32  # a partial output is summed in float32
    y = torch.zeros((T, D), dtype=acc, device=xt.device).index_add(0, token, contrib.to(acc))
    return _leave_region(p, y).to(xt.dtype), aux


def moe_apply(p: MoE, x: torch.Tensor, cfg: ArchConfig, rows=None, want_aux: bool = True):
    """x (B, L, D) → (y, aux | None): the tokens flat, grouped by the
    dispatch.  ``rows``: the split of the step's rows over the batch axes
    (``dist.sharding.rows_split``), None where this rank's rows are the
    whole batch.  Without ``want_aux`` (serving, which reads no aux loss:
    XLA drops them from ``repro``'s serving steps) the aux losses are not
    computed."""
    m = cfg.moe
    B, L, D = x.shape
    if m.dispatch == "einsum":
        y, aux = _einsum_moe(p, x.reshape(B * L, D), cfg, rows, want_aux)
    elif m.dispatch == "scatter":
        y, aux = _scatter_moe(p, x.reshape(B * L, D), cfg, rows, want_aux)
    else:
        raise ValueError(f"unknown moe dispatch {m.dispatch!r}")
    y = y.reshape(B, L, D)
    if m.n_shared_experts:
        y = y + p.shared(x)
    return y, aux
