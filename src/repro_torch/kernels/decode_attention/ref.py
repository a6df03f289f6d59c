"""Plain PyTorch version of decode attention: the twin of
``repro/kernels/decode_attention/ref.py`` with what the serve engine needs
and the TPU kernel lacks: a per-sequence ``(B,)`` position (the JAX oracle
takes a scalar) and the model's (B, S, KH, D) cache layout.

Slot ``s`` of sequence ``b`` is valid where ``s < min(pos[b] + 1, S)``: for a
full cache that is ``s <= pos[b]``, and for a ring cache of S == window slots
it is the ring rule of ``repro.models.attention.decode_attention``.

A slice of a sequence-sharded cache (its slot 0 the global slot
``slot_offset``) keeps the global rule: slot ``s`` is valid where
``slot_offset + s < min(pos[b] + 1, S_global)``, i.e. ``s < min(pos[b] + 1 -
slot_offset, S)``.  With ``partial`` the result is the slice's float32
output, normalised within the slice, and its log-sum-exp (B, H): ``-inf``,
with a zero output, where the slice holds no valid slot."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(
    q: torch.Tensor,        # (B, 1, H, Dh)
    k_cache: torch.Tensor,  # (B, S, KH, Dh)
    v_cache: torch.Tensor,  # (B, S, KH, Dv)
    pos: torch.Tensor,      # (B,) int32
    slot_offset: int = 0,
    partial: bool = False,
):
    B, _, H, Dh = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    qg = q.float().reshape(B, KH, G, Dh)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) / math.sqrt(Dh)
    n_valid = torch.clamp(pos.long() + 1 - slot_offset, max=S)
    valid = torch.arange(S, device=q.device)[None, :] < n_valid[:, None]
    if partial:
        s = torch.where(valid[:, None, None, :], s, torch.full((), -math.inf, device=q.device))
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
        den = e.sum(dim=-1, keepdim=True)
        out = torch.einsum("bhgs,bshd->bhgd", e, v_cache.float()) / torch.where(den > 0, den, torch.ones_like(den))
        lse = torch.where(den > 0, m + torch.log(den), torch.full((), -math.inf, device=q.device))
        return out.reshape(B, 1, H, v_cache.shape[-1]), lse.reshape(B, H)
    s = torch.where(valid[:, None, None, :], s, torch.full((), -1e30, device=q.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", w, v_cache.float())
    return out.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)
