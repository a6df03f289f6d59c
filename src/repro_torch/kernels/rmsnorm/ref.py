"""Plain PyTorch version of the fused RMSNorm: the twin of
``repro/kernels/rmsnorm/ref.py``.  Used for CPU tensors, by the tests, and by
``chip_smoke.py`` as the yardstick the kernel is held against."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)
