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
* there are no sharding or donation arguments: the step runs on one card
  (sharded state waits for ROADMAP.md, Queue 1 item 5).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import SpData, SpRuntime, sp_task
from repro_torch.dist.collectives import compress_int8, decompress_int8, int8_scale
from repro_torch.models import init_params, loss_fn, set_trainable
from repro_torch.models.config import ArchConfig
from repro_torch.models.param import DTYPES
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
    metrics.value = {
        "loss": metrics.value["loss"] + loss.detach().float(),
        "ce_loss": metrics.value["ce_loss"] + m["ce_loss"].detach().float(),
    }
    return loss.detach()


@sp_task(write=("grads",), name="grad_allreduce", cost=3.0, comm=True)
def _grad_finalize_codelet(grads, *, n_mb, compress, leaves):
    """Mean + (optional) int8 quantize-dequantize, in place.  Each of
    ``repro``'s leaves (a layer parameter stacked over the layers) is
    quantized with one scale, as ``repro``'s ``compress_tree`` does; the
    error-feedback residuals are zero inside one step, as there."""
    g = grads.value
    with torch.no_grad():
        for t in g.values():
            t.div_(n_mb)
        if compress:
            for leaf in leaves:
                parts = [g[n] for n in leaf.names]
                scale = int8_scale(*parts)
                for t in parts:
                    t.copy_(decompress_int8(*compress_int8(t, scale=scale)))
    grads.value = g


@sp_task(read=("grads",), write=("params", "opt", "new_step"), name="optimizer", cost=5.0)
def _optimizer_codelet(grads, params, opt, new_step, *, opt_update, lr_schedule, clip_norm, step):
    """Clip + nonfinite check + branchless speculative update: the update is
    computed unconditionally; rollback = keep the old bits."""
    gnorm = global_norm(grads.values())
    finite = torch.isfinite(gnorm)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    opt_update(grads, opt.value, dict(params.value.named_parameters()), lr_schedule(step), step,
               accept=finite, grad_scale=scale)
    new_step.value = step + 1
    return gnorm


class TrainStepArtifacts:
    """The step function and the schedule it ran (``schedule_names``)."""

    def __init__(self, step_fn, schedule_names):
        self.step_fn = step_fn
        self.schedule_names = schedule_names

    def __call__(self, state, batch):
        return self.step_fn(state, batch)


def init_train_state(cfg: ArchConfig, seed: int = 0, *, device="cuda") -> TrainState:
    """Seeded parameters (``repro``'s init rules, drawn on ``device``), made
    trainable, with a zero step counter and fresh optimizer state."""
    model = set_trainable(init_params(cfg, seed, device=device))
    opt_init, _ = make_optimizer(cfg.optimizer, cfg.opt_state_dtype)
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
    with ``metrics`` = {"loss", "ce_loss", "grad_norm"} as device tensors.
    ``batch`` holds ``tokens`` and ``labels`` (B, L) on the model's device;
    B must divide into ``n_microbatches``."""
    lr_schedule = lr_schedule or (
        lambda step: torch.tensor(3e-4, dtype=torch.float32, device=step.device))
    _, opt_update = make_optimizer(cfg.optimizer, cfg.opt_state_dtype)
    accum_dtype = DTYPES[grad_accum_dtype]
    schedule_names: list[str] = []
    accum: dict = {}  # the gradient accumulator, kept between steps

    def zero_grads(model) -> dict:
        if accum.get("model") is not model:
            accum.clear()
            accum["model"] = model
            accum["grads"] = {n: torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                              for n, p in model.named_parameters()}
        else:
            for t in accum["grads"].values():
                t.zero_()
        return accum["grads"]

    def train_step(state: TrainState, batch: dict):
        model = state.params
        n_mb = n_microbatches
        grads_c = SpData(zero_grads(model), "grads")
        zero = torch.zeros((), dtype=torch.float32, device=model.device)
        metrics_c = SpData({"loss": zero, "ce_loss": zero}, "metrics")
        params_c = SpData(model, "params")
        opt_c = SpData(state.opt, "opt")
        new_step_c = SpData(None, "new_step")
        mb_batch = {k: t.reshape((n_mb, t.shape[0] // n_mb) + tuple(t.shape[1:]))
                    for k, t in batch.items()}
        leaves = param_leaves(n for n, _ in model.named_parameters())

        with SpRuntime(backend="staged", policy=schedule_policy) as rt:
            for i in range(n_mb):
                mb_c = SpData({k: t[i] for k, t in mb_batch.items()}, f"mb{i}")
                _microbatch_codelet(params_c, mb_c, grads_c, metrics_c, cfg=cfg, name=f"mb{i}")
            _grad_finalize_codelet(grads_c, n_mb=n_mb, compress=grad_compression, leaves=leaves)
            gnorm_view = _optimizer_codelet(
                grads_c, params_c, opt_c, new_step_c,
                opt_update=opt_update, lr_schedule=lr_schedule, clip_norm=clip_norm,
                step=state.step,
            )
            order = rt.run()
        if not schedule_names:
            schedule_names.extend(t.name for t in order)

        metrics = {k: v / n_mb for k, v in metrics_c.value.items()}
        metrics["grad_norm"] = gnorm_view.result()
        return TrainState(step=new_step_c.value, params=params_c.value, opt=opt_c.value), metrics

    return TrainStepArtifacts(train_step, schedule_names)
