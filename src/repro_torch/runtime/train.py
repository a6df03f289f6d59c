"""The train step built from codelets and run on the staged backend — the
port of ``repro.runtime.train``.

Task structure of one step (N microbatches), three codelets declared once::

    mb_0 ... mb_{N-1}   read(params), read(batch_i),
                        commutative(grads)             ← order-free accumulation
    grad_finalize       comm task: mean (+ int8 quantize-dequantize)
    optimizer           write(params/opt): clip + nonfinite check +
                        *speculative* update — computed unconditionally,
                        kept by ``torch.where(finite, new, old)`` (the
                        branchless analogue of SpMaybeWrite + rollback)

The step runs on ``SpRuntime(backend="staged")``: the policy decides the
program order (``overlap`` issues the comm task as soon as its inputs are
ready), and the bodies run in that order on the calling thread, each
enqueuing its kernels on the card's stream.  Nothing in the step reads a
value back to the host (no ``.item()``, no branch on the finite flag).

What differs from ``repro``:

* gradients come from ``torch.autograd.grad`` (the counterpart of
  ``jax.value_and_grad``) and are **added in place** into a float32 (or
  ``grad_accum_dtype``) accumulator that the artifact keeps between steps;
* the optimizer updates the model's parameters and its own state **in
  place** (``repro`` returns new trees and donates the old ones), so the
  returned :class:`TrainState` holds the same module and tensors with a new
  step counter;
* there are no sharding or donation arguments.  Built inside
  ``dist.sharding.use_mesh(mesh)`` (a ``torch.distributed`` device mesh,
  one rank a process), the step is **data-parallel** over the batch's mesh
  axes: every rank is given the same global batch and computes on its own
  rows of it along ``pod`` × ``data`` (where they divide it, as
  ``safe_spec`` decides), and ``grad_finalize`` averages the gradients
  across those ranks before the optimizer (``all_reduce(axis=…)``'s mean,
  or ``hierarchical_psum`` over the rank count with a ``pod`` axis); the
  metrics are means over the ranks too.
* with a ``model`` axis of m > 1 the step is also **tensor-parallel**: the
  model (built under the same mesh) holds this rank's part of each
  parameter (``safe_spec`` of its ``ParamDef`` axes), its forward and
  backward run over those parts (``models/attention.py``,
  ``models/layers.py``), the gradients stay local but for the parameters
  replicated inside a sharded region (``models.partial_grad_names``), which
  ``grad_finalize`` sums over ``model``, as GSPMD does in ``repro``; AdamW's
  ``m`` / ``v`` are local parts and Adafactor's state is whole on every rank
  (:func:`train_state_shardings`); the global norm sums the sharded
  gradients' squares over ``model``.  Each metric is the same on every
  ``model`` rank.  Block kinds ``"attn"``, ``"moe"`` (expert
  parallelism, ``models/moe.py``; its ``moe_balance`` and ``moe_zloss``
  are each one process's) and ``"mla"`` run there; the others raise
  (``models.check_model_axis``).  A MoE model routes over the global
  batch (the step declares its rows' split: ``dist.sharding.split_rows``),
  so its batch must split over every batch axis of the mesh.
  Off-mesh the step runs on one card as
  before.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from repro_torch.core import SpData, SpRuntime, sp_task
from repro_torch.dist.collectives import (
    all_reduce,
    compress_int8,
    decompress_int8,
    hierarchical_psum,
    int8_scale,
    mesh_psum_,
    model_sum_,
)
from repro_torch.dist.sharding import (
    PartitionSpec,
    batch_axes,
    current_mesh,
    mesh_shape,
    safe_spec,
    split_rows,
    use_mesh,
)
from repro_torch.models import abstract_params, init_params, leaf_layout, loss_fn, model_defs, set_trainable
from repro_torch.models.config import ArchConfig
from repro_torch.models.param import DTYPES, sharding_tree
from repro_torch.models.transformer import check_model_axis, partial_grad_names
from repro_torch.optim import TrainState, global_norm, make_optimizer, param_leaves


# ---------------------------------------------------------------------------
# The three task shapes of a train step (codelet frontend, core/api.py).
# ---------------------------------------------------------------------------

@sp_task(read=("params", "mb"), commutative=("grads", "metrics"), name="mb", cost=10.0)
def _microbatch_codelet(params, mb, grads, metrics, *, cfg):
    """Forward + backward over one microbatch; order-free accumulation."""
    names, tensors = zip(*params.named_parameters())
    with torch.enable_grad():
        loss, m = loss_fn(params, mb, cfg)
        g = torch.autograd.grad(loss, tensors)
    acc = grads.value
    with torch.no_grad():
        for n, gg in zip(names, g):
            acc[n].add_(gg)
    del g
    m = dict(m, loss=loss)
    metrics.value = {k: v + m[k].detach().float() for k, v in metrics.value.items()}
    return loss.detach()


def _rank_mean_(t: torch.Tensor, axes: tuple) -> None:
    """Replace ``t`` by its mean over the ranks of the mesh axes ``axes``:
    over ``pod`` and ``data`` the pod-aware ``hierarchical_psum`` over their
    rank count, else an in-place sum over the axes over the rank count."""
    if len(axes) == 2 and axes[0] == "pod":
        sizes = mesh_shape(current_mesh())
        t.copy_(hierarchical_psum(t, pod_axis="pod", inner_axis=axes[1])).div_(sizes["pod"] * sizes[axes[1]])
    else:
        t.div_(mesh_psum_(t, axes))


@sp_task(write=("grads",), name="grad_allreduce", cost=3.0, comm=True)
def _grad_finalize_codelet(grads, *, n_mb, compress, leaves, dp_axes, tp):
    """Mean over the microbatches, then over the data-parallel ranks of
    the mesh axes ``dp_axes`` (none off-mesh), the sum over ``model`` of the
    gradients each rank holds a part of (``tp``: the model's
    :class:`_ModelAxisPlan`, None off a ``model`` axis), + (optional) int8
    quantize-dequantize, in place.  Each of ``repro``'s leaves (a layer
    parameter stacked over the layers) is quantized with one scale, as
    ``repro``'s ``compress_tree`` does (over ``model`` too for a sharded
    leaf); the error-feedback residuals are zero inside one step, as
    there."""
    g = grads.value
    with torch.no_grad():
        for t in g.values():
            t.div_(n_mb)
            if dp_axes:
                _rank_mean_(t, dp_axes)
        if tp is not None:
            for n in tp.partial:
                model_sum_(g[n], tp.group)
        if compress:
            for leaf in leaves:
                parts = [g[n] for n in leaf.names]
                sharded = tp is not None and tp.shards[leaf.names[0]].sharded
                scale = int8_scale(*parts, group=tp.group if sharded else None)
                for t in parts:
                    t.copy_(decompress_int8(*compress_int8(t, scale=scale)))
    grads.value = g


@sp_task(read=("grads",), write=("params", "opt", "new_step"), name="optimizer", cost=5.0)
def _optimizer_codelet(grads, params, opt, new_step, *, opt_update, lr_schedule, clip_norm, step, tp):
    """Clip + nonfinite check + branchless speculative update: the update is
    computed unconditionally; rollback = keep the old bits."""
    if tp is None:
        gnorm = global_norm(grads.values())
    else:
        gnorm = global_norm(grads.values(), sharded=[tp.shards[n].sharded for n in grads], group=tp.group)
    finite = torch.isfinite(gnorm)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    opt_update(grads, opt.value, dict(params.value.named_parameters()), lr_schedule(step), step,
               accept=finite, grad_scale=scale)
    new_step.value = step + 1
    return gnorm


class TrainStepArtifacts:
    """The step function, the schedule it ran (``schedule_names``) and the
    gradient accumulator it keeps between steps (``grads()``: name →
    tensor, None before the first step)."""

    def __init__(self, step_fn, schedule_names, accum=None):
        self.step_fn = step_fn
        self.schedule_names = schedule_names
        self._accum = accum if accum is not None else {}

    def grads(self):
        return self._accum.get("grads")

    def __call__(self, state, batch):
        return self.step_fn(state, batch)


class _ModelAxisPlan:
    """What the step needs of a model built on a ``model`` axis: the axis'
    group, each parameter's ``Shard`` and the gradients to sum over it."""

    def __init__(self, model):
        self.group = model.tp.group
        self.shards = model.shards
        self.partial = partial_grad_names(model)


def train_state_shardings(cfg: ArchConfig, mesh=None) -> TrainState:
    """The ``PartitionSpec`` of every leaf of the train state in ``repro``'s
    tree (:func:`abstract_train_state`) on ``mesh`` (default: the active
    mesh): the parameters by their ``ParamDef`` axes, AdamW's ``m`` / ``v``
    mirroring them, Adafactor's state and the step replicated — ``repro``'s
    ``train_state_shardings``."""
    p_sh = sharding_tree(model_defs(cfg), mesh)
    if cfg.optimizer == "adamw":
        opt_sh = {"m": p_sh, "v": p_sh}
    else:
        opt_sh = _map_leaves(lambda _: PartitionSpec(), abstract_train_state(cfg).opt)
    return TrainState(step=PartitionSpec(), params=p_sh, opt=opt_sh)


def _map_leaves(fn, tree):
    return {k: _map_leaves(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def abstract_train_state(cfg: ArchConfig) -> TrainState:
    """The train state in ``repro``'s tree as ``meta`` tensors at their whole
    shapes (no storage): the parameters (layers stacked), the optimizer
    state keyed as ``repro`` keys it, an int32 step.  On a mesh each rank
    holds the part :func:`train_state_shardings` gives."""
    params = abstract_params(cfg)
    meta = lambda shape: torch.empty(shape, dtype=torch.float32, device="meta")  # noqa: E731
    if cfg.optimizer == "adamw":
        dt = DTYPES[cfg.opt_state_dtype]
        opt = {k: _map_leaves(lambda t: torch.empty(t.shape, dtype=dt, device="meta"), params)
               for k in ("m", "v")}
    else:  # adafactor: repro's factoring of each (stacked) leaf
        opt = _map_leaves(lambda t: ({"vr": meta(t.shape[:-1]), "vc": meta(t.shape[:-2] + t.shape[-1:])}
                                     if t.dim() >= 2 and t.shape[-1] > 1 and t.shape[-2] > 1
                                     else {"v": meta(t.shape)}), params)
    return TrainState(step=torch.empty((), dtype=torch.int32, device="meta"), params=params, opt=opt)


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def state_bytes(state: TrainState, art: Optional[TrainStepArtifacts] = None) -> dict:
    """Bytes this rank holds of the parameters, the optimizer state and
    (with ``art``, after a step) the gradient accumulator."""
    out = {"params": sum(p.numel() * p.element_size() for p in state.params.parameters()),
           "opt": _nbytes(state.opt)}
    if art is not None and art.grads() is not None:
        out["grads"] = _nbytes(art.grads())
    return out


def _model_optimizer(cfg: ArchConfig, model):
    """make_optimizer for ``model``: its leaf layout, and its shards and
    ``model`` axis group when it was built on one."""
    tp = model.tp
    return make_optimizer(cfg.optimizer, cfg.opt_state_dtype, leaf_layout(cfg), shards=model.shards,
                          group=None if tp is None else tp.group)


def init_train_state(cfg: ArchConfig, seed: int = 0, *, device="cuda") -> TrainState:
    """Seeded parameters (``repro``'s init rules, drawn on ``device``), made
    trainable, with a zero step counter and fresh optimizer state.  Under a
    mesh with a ``model`` axis each rank holds its part of them."""
    model = set_trainable(init_params(cfg, seed, device=device))
    opt_init, _ = _model_optimizer(cfg, model)
    opt = opt_init(dict(model.named_parameters()))
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=model.device),
                      params=model, opt=opt)


def build_train_step(
    cfg: ArchConfig,
    *,
    n_microbatches: int = 1,
    schedule_policy: str = "overlap",
    lr_schedule: Optional[Callable] = None,
    clip_norm: float = 1.0,
    grad_accum_dtype: str = "float32",
    grad_compression: bool = False,
) -> TrainStepArtifacts:
    """Build the staged train step: ``art(state, batch) → (state, metrics)``
    with ``metrics`` = {"loss", "ce_loss", "grad_norm"} as device tensors,
    and for a MoE model ``loss_fn``'s "moe_balance" / "moe_zloss" (each the
    mean over the microbatches, as the losses are).
    ``batch`` holds ``tokens`` and ``labels`` (B, L) on the model's device;
    B must divide into ``n_microbatches``.  Built inside ``use_mesh(mesh)``
    the step is data-parallel over the mesh (module docstring): B must
    then divide into the ranks of the batch's mesh axes × ``n_microbatches``
    (axes that do not divide it are dropped, as ``safe_spec`` drops them)."""
    mesh = current_mesh()
    check_model_axis(cfg, mesh)
    lr_schedule = lr_schedule or (
        lambda step: torch.tensor(3e-4, dtype=torch.float32, device=step.device))
    layout = leaf_layout(cfg)
    metric_keys = ("loss", "ce_loss") + (("moe_balance", "moe_zloss") if cfg.family == "moe" else ())
    accum_dtype = DTYPES[grad_accum_dtype]
    schedule_names: list[str] = []
    accum: dict = {}  # the gradient accumulator, kept between steps

    def zero_grads(model) -> dict:
        if accum.get("model") is not model:
            accum.clear()
            accum["model"] = model
            accum["grads"] = {n: torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                              for n, p in model.named_parameters()}
            accum["opt_update"] = _model_optimizer(cfg, model)[1]
            accum["tp"] = None if model.tp is None else _ModelAxisPlan(model)
        else:
            for t in accum["grads"].values():
                t.zero_()
        return accum["grads"]

    def local_rows(batch: dict) -> tuple[dict, tuple]:
        """This rank's rows of the global batch and the mesh axes they are
        spread over (the whole batch and () off-mesh)."""
        if mesh is None:
            return batch, ()
        B = next(iter(batch.values())).shape[0]
        entry = safe_spec((B,), ("batch",), mesh=mesh)[0]
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        sizes = mesh_shape(mesh)
        split = batch_axes(mesh)
        want = () if split is None else split.axes
        if cfg.family == "moe" and tuple(a for a in axes if sizes[a] > 1) != want:
            raise ValueError(f"a MoE step routes over the global batch of the mesh's batch axes {want}; "
                             f"a batch of {B} splits over {axes}")
        index, n = 0, 1
        for a in axes:
            index, n = index * sizes[a] + mesh.get_local_rank(a), n * sizes[a]
        rows = B // n
        return {k: t[index * rows:(index + 1) * rows] for k, t in batch.items()}, axes

    def train_step(state: TrainState, batch: dict):
        model = state.params
        n_mb = n_microbatches
        batch, dp_axes = local_rows(batch)
        grads_c = SpData(zero_grads(model), "grads")
        zero = torch.zeros((), dtype=torch.float32, device=model.device)
        metrics_c = SpData(dict.fromkeys(metric_keys, zero), "metrics")
        params_c = SpData(model, "params")
        opt_c = SpData(state.opt, "opt")
        new_step_c = SpData(None, "new_step")
        mb_batch = {k: t.reshape((n_mb, t.shape[0] // n_mb) + tuple(t.shape[1:]))
                    for k, t in batch.items()}
        leaves = param_leaves((n for n, _ in model.named_parameters()), layout)

        # the mesh the step was built under, wherever it is called from
        with use_mesh(mesh) if mesh is not None else contextlib.nullcontext(), split_rows(dp_axes), \
                SpRuntime(backend="staged", policy=schedule_policy) as rt:
            for i in range(n_mb):
                mb_c = SpData({k: t[i] for k, t in mb_batch.items()}, f"mb{i}")
                _microbatch_codelet(params_c, mb_c, grads_c, metrics_c, cfg=cfg, name=f"mb{i}")
            _grad_finalize_codelet(grads_c, n_mb=n_mb, compress=grad_compression, leaves=leaves,
                                   dp_axes=dp_axes, tp=accum["tp"])
            gnorm_view = _optimizer_codelet(
                grads_c, params_c, opt_c, new_step_c,
                opt_update=accum["opt_update"], lr_schedule=lr_schedule, clip_norm=clip_norm,
                step=state.step, tp=accum["tp"],
            )
            order = rt.run()
            metrics = {k: v / n_mb for k, v in metrics_c.value.items()}
            if dp_axes:
                metrics = {k: all_reduce(v, axis=dp_axes, op="mean") for k, v in metrics.items()}
        if not schedule_names:
            schedule_names.extend(t.name for t in order)

        metrics["grad_norm"] = gnorm_view.result()
        return TrainState(step=new_step_c.value, params=params_c.value, opt=opt_c.value), metrics

    return TrainStepArtifacts(train_step, schedule_names, accum)
