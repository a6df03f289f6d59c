"""Plain PyTorch versions of flash attention and of its backward: the
forward is the twin of ``repro/kernels/flash_attention/ref.py``, in the
model's (B, L, H, D) layout that the CUDA kernels read (the JAX oracle takes
(B, H, L, D)); the backward is the recurrence of ``repro``'s FlashAttention-2
custom VJP (``repro/models/attention.py::_make_flash``)."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30  # masked score: large and finite, as the kernels and repro use


def _mask(Lq: int, Lk: int, causal: bool, window: Optional[int], q_offset: int, device):
    qpos = q_offset + torch.arange(Lq, device=device)
    kpos = torch.arange(Lk, device=device)
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    return mask


def _scores(q, k, causal, window, q_offset):
    """Scaled, masked scores (B, KH, G, Lq, Lk) in float32."""
    B, Lq, H, Dh = q.shape
    Lk, KH = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Lq, KH, H // KH, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(Dh)
    mask = _mask(Lq, Lk, causal, window, q_offset, q.device)
    return torch.where(mask, s, torch.full((), NEG_INF, device=q.device))


def attention_fwd_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0):
    """→ (out (B, Lq, H, Dv) in q's dtype, lse (B, H, Lq) float32), where
    lse is the natural log-sum-exp of each row's scaled, masked scores (the
    residual of ``repro``'s custom VJP: ``m + log(l)``)."""
    B, Lq, H, _ = q.shape
    s = _scores(q, k, causal, window, q_offset)
    lse = torch.logsumexp(s, dim=-1)
    w = torch.exp(s - lse[..., None])
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(B, Lq, H, v.shape[-1]).to(q.dtype), lse.reshape(B, H, Lq)


def attention_ref(
    q: torch.Tensor,  # (B, Lq, H, Dh)
    k: torch.Tensor,  # (B, Lk, KH, Dh)
    v: torch.Tensor,  # (B, Lk, KH, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    B, Lq, H, _ = q.shape
    w = torch.softmax(_scores(q, k, causal, window, q_offset), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(B, Lq, H, v.shape[-1]).to(q.dtype)


def attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                      window: Optional[int] = None, q_offset: int = 0):
    """→ (dq, dk, dv) in the inputs' dtypes, float32 inside:
    D = rowsum(dO∘O), P = exp(S·scale − lse) (masked scores −1e30, as in the
    forward), dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P∘(dP − D)·scale, dQ = dS·K,
    dK = dSᵀ·Q; dK and dV summed over the G query heads of each KV head."""
    B, Lq, H, Dh = q.shape
    Lk, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KH
    scale = 1.0 / math.sqrt(Dh)
    p = torch.exp(_scores(q, k, causal, window, q_offset) - lse.reshape(B, KH, G, Lq)[..., None])
    do = dout.float().reshape(B, Lq, KH, G, Dv)
    Dvec = torch.einsum("bqhgd,bqhgd->bhgq", do, out.float().reshape(B, Lq, KH, G, Dv))
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, v.float())
    ds = p * (dp - Dvec[..., None]) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(B, Lq, H, Dh)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q.float().reshape(B, Lq, KH, G, Dh))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
