"""Plain PyTorch versions of the fused RMSNorm and of its backward: the
forward is the twin of ``repro/kernels/rmsnorm/ref.py``; the backward is
what JAX's autodiff of ``repro.models.layers.rmsnorm`` computes.  Used for
CPU tensors, by the tests, and by ``chip_smoke.py`` as the yardstick the
kernels are held against."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6):
    """→ (dx, dscale) of ``rmsnorm_ref``: with x̂ = x·rstd and w = 1 + scale,
    dx = rstd·(dy·w − x̂·mean(dy·w·x̂)) and dscale = Σ_rows dy·x̂, all in
    float32, cast once to x's and scale's dtypes."""
    xf, gf = x.float(), dy.float()
    rstd = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    gw = gf * (1.0 + scale.float())
    dx = rstd * (gw - xhat * torch.mean(gw * xhat, dim=-1, keepdim=True))
    dscale = (gf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)
