"""Plain PyTorch version of decode attention: the twin of
``repro/kernels/decode_attention/ref.py`` with what the serve engine needs
and the TPU kernel lacks: a per-sequence ``(B,)`` position (the JAX oracle
takes a scalar) and the model's (B, S, KH, D) cache layout.

Slot ``s`` of sequence ``b`` is valid where ``s < min(pos[b] + 1, S)``: for a
full cache that is ``s <= pos[b]``, and for a ring cache of S == window slots
it is the ring rule of ``repro.models.attention.decode_attention``."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(
    q: torch.Tensor,        # (B, 1, H, Dh)
    k_cache: torch.Tensor,  # (B, S, KH, Dh)
    v_cache: torch.Tensor,  # (B, S, KH, Dv)
    pos: torch.Tensor,      # (B,) int32
) -> torch.Tensor:
    B, _, H, Dh = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    qg = q.float().reshape(B, KH, G, Dh)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) / math.sqrt(Dh)
    n_valid = torch.clamp(pos.long() + 1, max=S)
    valid = torch.arange(S, device=q.device)[None, :] < n_valid[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full((), -1e30, device=q.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", w, v_cache.float())
    return out.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)
