"""Wrapper for the fused RMSNorm kernel (``csrc/rmsnorm.cu``).

Replaces ``src/repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas``.  On this
card the work is bound by device-memory bytes (one read of x, one write of
the output); the kernel keeps one block per row so any row count works and
re-reads the row from cache for the scaling pass.  A CPU tensor takes the
plain version in ``ref.py``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch

from .ref import rmsnorm_ref

#: launches of the kernel through :func:`rmsnorm` (``.count``)
launches = dispatch.LaunchCounter()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., D), scale (D,) -> x * rsqrt(mean(x^2) + eps) * (1 + scale)."""
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    dispatch.check_cuda_tensors("rmsnorm", x, scale)
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
    lib = dispatch.library()
    rc = lib.rmsnorm_fwd(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D, float(eps),
        x_code, s_code, dispatch.stream_handle(x),
    )
    dispatch.check(rc, "rmsnorm")
    launches.add()
    return out
