"""Wrappers for the fused RMSNorm kernel and its backward
(``csrc/rmsnorm.cu``), and the autograd function over them.

Replaces ``src/repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas``.  On this
card the work is bound by device-memory bytes (one read of x, one write of
the output): the kernel reads 16 bytes a thread and holds the row in
registers between the reduction and the scaling.  :func:`launch_plan`
chooses how many threads share a row and how many rows share a block.  A
CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches the
kernel or raises; ``meta`` tensors take the meta route (``dispatch``).

The backward (:func:`rmsnorm_bwd`) has no Pallas counterpart: JAX
differentiates the jnp ``repro.models.layers.rmsnorm``.  It covers a row
as the forward does, with 512-thread blocks, one an SM, that load each
row ahead (:func:`bwd_launch_plan`), and reduces ``dscale`` over the rows
in float32 in a fixed order.
:class:`RMSNormFn` ties the two together for training.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.api import sp_task
from repro_torch.kernels import dispatch

from .ref import rmsnorm_bwd_ref, rmsnorm_ref

#: launches of the kernel through :func:`rmsnorm` (``.count``)
launches = dispatch.LaunchCounter()
#: launches of the backward through :func:`rmsnorm_bwd`
bwd_launches = dispatch.LaunchCounter()

#: vectors a thread holds in registers at most (csrc/rmsnorm.cu MAX_VPT)
MAX_VPT = 4
#: threads of a backward block on the register path (csrc/rmsnorm.cu BWD_THREADS)
BWD_THREADS = 512


class LaunchPlan(NamedTuple):
    """How ``rmsnorm_kernel`` covers a (rows, D) input.

    Thread ``t`` of a row's ``tpr`` threads handles vectors ``j·tpr + t`` of
    ``vec`` elements for ``j < vpt`` (``vpt == 0``: every ``tpr``-th vector in
    a loop), dropping those past ``D / vec``."""

    vec: int  # elements per load: 16 bytes' worth, or 1 (the scalar path)
    vpt: int  # vectors per thread held in registers; 0 = the looped variant
    tpr: int  # threads per row, a power of two
    rows_per_block: int
    blocks: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def launch_plan(rows: int, D: int, itemsize: int, aligned: bool,
                sms: Optional[int] = None) -> LaunchPlan:
    """The plan for ``rows`` rows of ``D`` elements of ``itemsize`` bytes.
    ``aligned``: x, out and scale start on 16 bytes (then, with D a multiple
    of the vector, so does every row).  Given the card's ``sms``, the grid
    holds at most 1024 threads per SM and a block takes every ``blocks``-th
    group of rows, loading the next while it writes the current one (at
    (2048, 4096) bf16 that took the kernel from ~70% to ~93% of the bytes
    bound on an H100, in ``chip_smoke.py``)."""
    full = 16 // itemsize
    vec = full if aligned and D % full == 0 else 1
    nvec = D // vec
    if nvec <= 32 * MAX_VPT:  # a warp or less per row, several rows per block
        tpr = min(32, _pow2_at_least(nvec))
        rows_per_block = 128 // tpr
    else:  # one row per block of 128 or 256 threads, ~2 vectors a thread
        tpr = min(256, _pow2_at_least(-(-nvec // 2)))
        rows_per_block = 1
    vpt = -(-nvec // tpr)
    if vpt > MAX_VPT:
        vpt = 0
    blocks = -(-rows // rows_per_block)
    if sms is not None:
        blocks = min(blocks, sms * (1024 // (tpr * rows_per_block)))
    return LaunchPlan(vec, vpt, tpr, rows_per_block, blocks)


def bwd_launch_plan(rows: int, D: int, itemsize: int, aligned: bool,
                    sms: Optional[int] = None) -> LaunchPlan:
    """The backward's plan: the forward's coverage of a row (``vec``,
    ``vpt``, ``tpr``).  On the register path a block of ``BWD_THREADS``
    threads holds ``BWD_THREADS // tpr`` row groups and, given ``sms``, one
    block runs on each SM, with the rows spread so that every block walks
    the same number of them; each thread loads the next row's x and dy
    while it reduces and writes the current one.  A block's row groups add
    their float32 ``dscale`` partial sums in shared memory, so the kernel
    writes one partial row of D per block: (blocks, D) in all.  The looped
    path keeps one row group a block and at most 512 threads an SM."""
    fwd = launch_plan(rows, D, itemsize, aligned)
    if fwd.vpt == 0:
        rpb, per_sm = 1, max(1, BWD_THREADS // fwd.tpr)
    else:
        rpb, per_sm = BWD_THREADS // fwd.tpr, 1
    groups = -(-rows // rpb)  # row groups' worth of rows
    blocks = groups
    if sms is not None and groups > sms * per_sm:
        walks = -(-groups // (sms * per_sm))  # rows each row group walks
        blocks = -(-groups // walks)
    return LaunchPlan(fwd.vec, fwd.vpt, fwd.tpr, rpb, blocks)


def fwd_flops(rows: int, D: int) -> int:
    """The forward's operations: squares, their sum, the scaling and the
    (1 + scale) product, one each an element."""
    return 4 * rows * D


def bwd_flops(rows: int, D: int) -> int:
    """The backward's operations: twice the forward's (dx and dscale)."""
    return 8 * rows * D


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., D), scale (D,) -> x * rsqrt(mean(x^2) + eps) * (1 + scale)."""
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    meta = dispatch.check_kernel_tensors("rmsnorm", x, scale)
    D = x.shape[-1]
    if tuple(scale.shape) != (D,):
        raise ValueError(f"rmsnorm: scale shape {tuple(scale.shape)} != ({D},)")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    x_code = dispatch.dtype_code("rmsnorm", x)
    s_code = dispatch.dtype_code("rmsnorm", scale)
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    if meta:
        dispatch.meta_launch("rmsnorm", (rows, D), fwd_flops(rows, D))
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, out))
    plan = launch_plan(rows, D, x.element_size(), aligned, dispatch.sm_count(x.device))
    lib = dispatch.library()
    rc = lib.rmsnorm_fwd(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D, float(eps),
        x_code, s_code, *plan, dispatch.stream_handle(x),
    )
    dispatch.check(rc, "rmsnorm")
    launches.add((rows, D))
    return out


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6):
    """→ (dx in x's dtype, dscale in scale's dtype) of :func:`rmsnorm` at
    ``x``; rstd is recomputed from x.  dy has x's shape and dtype."""
    if all(t.device.type == "cpu" for t in (x, scale, dy)):
        return rmsnorm_bwd_ref(x, scale, dy, eps)
    meta = dispatch.check_kernel_tensors("rmsnorm_bwd", x, scale, dy)
    D = x.shape[-1]
    if tuple(scale.shape) != (D,) or dy.shape != x.shape:
        raise ValueError(
            f"rmsnorm_bwd: x {tuple(x.shape)}, scale {tuple(scale.shape)}, dy {tuple(dy.shape)}"
        )
    if dy.dtype != x.dtype:
        raise TypeError(f"rmsnorm_bwd: dy {dy.dtype} differs from x {x.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous() and dy.is_contiguous()):
        raise ValueError("rmsnorm_bwd: x, scale and dy must be contiguous")
    x_code = dispatch.dtype_code("rmsnorm_bwd", x)
    s_code = dispatch.dtype_code("rmsnorm_bwd", scale)
    dx = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    if meta:
        dispatch.meta_launch("rmsnorm_bwd", (rows, D), bwd_flops(rows, D))
        return dx, dscale
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, dy, dx))
    plan = bwd_launch_plan(rows, D, x.element_size(), aligned, dispatch.sm_count(x.device))
    partial = torch.empty((plan.blocks, D), dtype=torch.float32, device=x.device)
    lib = dispatch.library()
    rc = lib.rmsnorm_bwd(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), partial.data_ptr(),
        dscale.data_ptr(), rows, D, float(eps), x_code, s_code, *plan,
        dispatch.stream_handle(x),
    )
    dispatch.check(rc, "rmsnorm_bwd")
    bwd_launches.add((rows, D))
    return dx, dscale


class RMSNormFn(torch.autograd.Function):
    """Differentiable RMSNorm: the forward kernel, and the backward kernel
    on the saved x and scale (nothing else is kept)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, None


def rmsnorm_train(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """:func:`rmsnorm` that autograd can differentiate."""
    return RMSNormFn.apply(x, scale, eps)


# -- codelet registration (SpCpu/SpCuda selection, paper §4.3) ---------------

@sp_task(read=("x", "scale"), write=("out",), name="rmsnorm")
def rmsnorm_codelet(x, scale, out, *, eps: float = 1e-6):
    out.value = rmsnorm_ref(x, scale, eps)


@rmsnorm_codelet.impl("cuda", available=dispatch.cuda_available)
def _rmsnorm_cuda_impl(x, scale, out, *, eps: float = 1e-6):
    out.value = rmsnorm(x, scale, eps)
