"""Attention: GQA / MQA / MHA with RoPE, prefill attention, KV cache, decode.

A port of ``repro.models.attention`` for block kind ``"attn"``.  The weights
keep the JAX layouts (``wq (D, H, Dh)``, ``wo (H, Dh, D)``).  Both attention
paths go through the CUDA kernels on the card, at every length:

* :func:`full_attention` → ``kernels/flash_attention`` (prefill and the
  train step; when autograd records, its ``FlashAttentionFn`` saves the
  forward's log-sum-exp and runs the backward kernel);
* :func:`decode_attention` → ``kernels/decode_attention`` with a ``(B,)``
  position per sequence (decode).

On the CPU the kernels' plain versions take their place; the JAX package's
jnp blockwise fallback is not ported.  The KV cache is updated **in place**
(:func:`kv_cache_update` writes one row per sequence), where ``repro``'s
``onehot`` update rewrites the whole cache functionally; the values are the
same.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import RMSNorm, apply_rope, make_params, rmsnorm
from repro_torch.models.param import ParamDef

Pos = Union[int, torch.Tensor]


def attn_defs(cfg: ArchConfig) -> dict:
    D, H, KH, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {
        "wq": ParamDef((D, H, Dh), ("embed", "heads", "head_dim")),
        "wk": ParamDef((D, KH, Dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((D, KH, Dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((H, Dh, D), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        out["bq"] = ParamDef((H, Dh), ("heads", "head_dim"), init="zeros")
        out["bk"] = ParamDef((KH, Dh), ("kv_heads", "head_dim"), init="zeros")
        out["bv"] = ParamDef((KH, Dh), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        out["q_norm"] = ParamDef((Dh,), (None,), init="zeros")
        out["k_norm"] = ParamDef((Dh,), (None,), init="zeros")
    return out


class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype, device):
        super().__init__()
        defs = attn_defs(cfg)
        norms = {k: defs.pop(k) for k in ("q_norm", "k_norm") if k in defs}
        make_params(self, defs, dtype=dtype, device=device)
        for name in norms:
            setattr(self, name, RMSNorm(cfg.head_dim, cfg.norm_eps, dtype=dtype, device=device))


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, L, D) @ w (D, n, Dh) → (B, L, n, Dh)."""
    D, n, Dh = w.shape
    return (x @ w.reshape(D, n * Dh)).reshape(*x.shape[:-1], n, Dh)


def qkv_project(p: Attention, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    """x (B, L, D) → q (B, L, H, Dh), k/v (B, L, KH, Dh), RoPE applied."""
    q = _project(x, p.wq)
    k = _project(x, p.wk)
    v = _project(x, p.wv)
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm.scale, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm.scale, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.contiguous()


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """(B, L, H, Dh) attention over the whole sequence: the flash kernel on
    the card at every length, its plain version on the CPU; differentiable
    through the backward kernel when autograd records."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return flash_ops.flash_attention_train(q, k, v, **kw)
    return flash_ops.flash_attention(q, k, v, **kw)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def kv_cache_shape(cfg: ArchConfig, batch: int, max_seq: int) -> tuple[int, ...]:
    W = cfg.attn_window
    S = min(max_seq, W) if W is not None else max_seq
    return (batch, S, cfg.n_kv_heads, cfg.head_dim)


def kv_cache_update(cache: torch.Tensor, new: torch.Tensor, slot: Pos) -> torch.Tensor:
    """Write ``new`` (B, 1, ...) at ``slot`` of ``cache`` (B, S, ...) **in
    place** and return it: a KV cache (B, S, KH, Dh), or MLA's latent
    caches (B, S, r).  ``slot`` is an int (every sequence) or a
    (B,) tensor (continuous batching: sequences at different positions)."""
    if isinstance(slot, torch.Tensor) and slot.ndim == 1:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, slot.long()] = new[:, 0].to(cache.dtype)
    else:
        cache[:, int(slot)] = new[:, 0].to(cache.dtype)
    return cache


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
) -> torch.Tensor:
    """One-token attention against a full or ring-buffered cache.

    q (B, 1, H, Dh); caches (B, S, KH, Dh); pos (B,) int32 — the new token's
    position.  Slots ``< min(pos + 1, S)`` are valid, which is ``repro``'s
    full-cache rule (``slot <= pos``) and its ring-window rule at once."""
    return decode_ops.decode_attention(q, k_cache, v_cache, pos)


def _out_project(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """out (B, L, H, Dh) @ wo (H, Dh, D) → (B, L, D)."""
    H, Dh, D = wo.shape
    return out.reshape(*out.shape[:-2], H * Dh) @ wo.reshape(H * Dh, D)


def attention_decode_step(
    p: Attention,
    x: torch.Tensor,
    cache: dict,
    pos: torch.Tensor,
    cfg: ArchConfig,
):
    """x (B, 1, D) new-token activations; cache {'k', 'v'} (B, S, KH, Dh),
    full or ring, updated in place; pos (B,) int32.  → (out (B, 1, D), cache)."""
    q, k, v = qkv_project(p, x, pos[:, None], cfg)
    S = cache["k"].shape[1]
    slot = pos % S if cfg.attn_window is not None else pos
    kv_cache_update(cache["k"], k, slot)
    kv_cache_update(cache["v"], v, slot)
    out = decode_attention(q, cache["k"], cache["v"], pos)
    return _out_project(out, p.wo), cache


def attention_apply(
    p: Attention,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ArchConfig,
    *,
    causal: bool = True,
    want_cache: bool = False,
):
    """Prefill attention over the full sequence → (y (B, L, D), {'k','v'} | None)."""
    q, k, v = qkv_project(p, x, positions, cfg)
    out = full_attention(q, k, v, causal=causal, window=cfg.attn_window)
    y = _out_project(out, p.wo)
    return y, ({"k": k, "v": v} if want_cache else None)
