"""Plain PyTorch version of flash attention: the twin of
``repro/kernels/flash_attention/ref.py``, in the model's (B, L, H, D) layout
that the CUDA kernel reads (the JAX oracle takes (B, H, L, D))."""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(
    q: torch.Tensor,  # (B, Lq, H, Dh)
    k: torch.Tensor,  # (B, Lk, KH, Dh)
    v: torch.Tensor,  # (B, Lk, KH, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    B, Lq, H, Dh = q.shape
    Lk, KH = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.float().reshape(B, Lq, KH, G, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(Dh)
    qpos = q_offset + torch.arange(Lq, device=q.device)
    kpos = torch.arange(Lk, device=q.device)
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(B, Lq, H, v.shape[-1]).to(q.dtype)
