"""Multi-head latent attention (MLA) — minicpm3-4b / DeepSeek-V2 style.

A port of ``repro.models.mla``.  Queries and KV are projected through
low-rank latents; the decode cache holds only the compressed latent
``c_kv`` (B, S, r_kv) and the shared RoPE key ``k_rope`` (B, S, d_rope).

* Prefill / train (:func:`mla_apply`) expands the latents to per-head K / V
  and runs the flash kernel with query / key head dim ``nope + rope`` and
  value head dim ``v_head_dim`` (96 and 64 for minicpm3-4b), at the scale
  1/sqrt(nope + rope).  ``torch.cat`` makes q and k contiguous, as the
  kernel's tensor-core route needs.
* Decode (:func:`mla_decode_step`) keeps ``repro``'s *absorbed* form: W_UK
  folds into the query and W_UV into the output, and the scores and the
  softmax run in float32 against the latent cache.  ``repro`` computes it
  with jnp einsums outside any Pallas kernel, so the port does it with
  torch ops.  The latent rows are written **in place** at each sequence's
  position (:func:`~repro_torch.models.attention.kv_cache_update`).

The weights keep ``repro``'s keys and layouts (``wq_b (r_q, H, nope +
rope)``, ``wo (H, v, D)``, ...); ``q_norm`` and ``kv_norm`` are
:class:`~repro_torch.models.layers.RMSNorm` modules (the rmsnorm kernel at
widths r_q and r_kv).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.attention import full_attention, kv_cache_update
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import RMSNorm, apply_rope, make_params
from repro_torch.models.param import ParamDef

NEG_INF = -1e30


def mla_defs(cfg: ArchConfig) -> dict:
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": ParamDef((D, m.q_lora_rank), ("embed", None)),
        "q_norm": ParamDef((m.q_lora_rank,), (None,), init="zeros"),
        "wq_b": ParamDef((m.q_lora_rank, H, qk), (None, "heads", None)),
        "wkv_a": ParamDef((D, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", None)),
        "kv_norm": ParamDef((m.kv_lora_rank,), (None,), init="zeros"),
        "wk_b": ParamDef((m.kv_lora_rank, H, m.qk_nope_head_dim), (None, "heads", None)),
        "wv_b": ParamDef((m.kv_lora_rank, H, m.v_head_dim), (None, "heads", None)),
        "wo": ParamDef((H, m.v_head_dim, D), ("heads", None, "embed")),
    }


def mla_cache_defs(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """One layer's decode cache: the latent ``c_kv`` and the RoPE key."""
    m = cfg.mla
    ax = ("batch", "kv_seq", None)
    return {
        "c_kv": ParamDef((batch, max_seq, m.kv_lora_rank), ax, dtype=cfg.dtype),
        "k_rope": ParamDef((batch, max_seq, m.qk_rope_head_dim), ax, dtype=cfg.dtype),
    }


class MLA(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype, device):
        super().__init__()
        defs = mla_defs(cfg)
        norms = {k: defs.pop(k) for k in ("q_norm", "kv_norm")}
        make_params(self, defs, dtype=dtype, device=device)
        for name, d in norms.items():
            setattr(self, name, RMSNorm(d.shape[0], cfg.norm_eps, dtype=dtype, device=device))


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., r) @ w (r, H, k) → (..., H, k)."""
    r, H, k = w.shape
    return (x @ w.reshape(r, H * k)).reshape(*x.shape[:-1], H, k)


def _project_q(p: MLA, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    m = cfg.mla
    q = _heads(p.q_norm(x @ p.wq_a), p.wq_b)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _project_kv_latent(p: MLA, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    m = cfg.mla
    c_kv, k_rope = torch.split(x @ p.wkv_a, [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = p.kv_norm(c_kv)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope  # (B, L, r_kv), (B, L, d_rope)


def mla_apply(p: MLA, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, *,
              causal: bool = True, want_cache: bool = False):
    """Training / prefill: expand the latents to per-head K / V and run the
    flash kernel.  x (B, L, D) → (y (B, L, D), {'c_kv', 'k_rope'} | None)."""
    m = cfg.mla
    q_nope, q_rope = _project_q(p, x, positions, cfg)
    c_kv, k_rope = _project_kv_latent(p, x, positions, cfg)
    k_nope = _heads(c_kv, p.wk_b)
    v = _heads(c_kv, p.wv_b)
    k_rope_h = k_rope[:, :, None, :].expand(*k_nope.shape[:3], m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    out = full_attention(q, k, v, causal=causal, window=cfg.attn_window)
    H, Dv, D = p.wo.shape
    y = out.reshape(*out.shape[:2], H * Dv) @ p.wo.reshape(H * Dv, D)
    return y, ({"c_kv": c_kv, "k_rope": k_rope} if want_cache else None)


def mla_decode_step(p: MLA, x: torch.Tensor, cache: dict, pos: torch.Tensor, cfg: ArchConfig):
    """Absorbed-matmul decode.  x (B, 1, D); cache {'c_kv': (B, S, r_kv),
    'k_rope': (B, S, d_rope)}, updated in place; pos (B,) int32 — the new
    token's position.  Slots ``<= pos`` are attended.  → (y (B, 1, D), cache)."""
    m = cfg.mla
    q_nope, q_rope = _project_q(p, x, pos[:, None], cfg)  # (B, 1, H, ·)
    c_kv_new, k_rope_new = _project_kv_latent(p, x, pos[:, None], cfg)
    c_cache = kv_cache_update(cache["c_kv"], c_kv_new, pos)
    r_cache = kv_cache_update(cache["k_rope"], k_rope_new, pos)
    S = c_cache.shape[1]
    c32 = c_cache.float()
    # absorb W_UK into q: q_lat (B, H, r_kv)
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], p.wk_b)
    s = torch.einsum("bhr,bsr->bhs", q_lat.float(), c32)
    s = s + torch.einsum("bhk,bsk->bhs", q_rope[:, 0].float(), r_cache.float())
    s = s / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    valid = torch.arange(S, device=pos.device)[None, :] <= pos[:, None]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    lat_out = torch.einsum("bhs,bsr->bhr", w, c32)
    v_out = torch.einsum("bhr,rhv->bhv", lat_out.to(x.dtype), p.wv_b)
    H, Dv, D = p.wo.shape
    y = v_out.reshape(-1, H * Dv) @ p.wo.reshape(H * Dv, D)
    return y[:, None], cache
