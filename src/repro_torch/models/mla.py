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

On a ``model`` mesh axis of m > 1 (``MLA.axis``) the layer follows
``repro``'s ``safe_spec``:

* with m dividing the heads (``MLA.tp``) ``wq_b``, ``wk_b``, ``wv_b`` and
  ``wo`` hold this rank's heads; ``wq_a``, ``q_norm``, ``wkv_a`` and
  ``kv_norm`` stay replicated and run on every rank.  The latents (the
  normed query latent, ``c_kv``, ``k_rope``) enter the tensor-parallel
  region through ``copy_to_model``, so the replicated projections get
  whole gradients; the output is summed over ``model``.  Otherwise the
  heads stay whole on every rank (minicpm3-4b's 40 heads at m = 16);
* the latent cache is ``repro``'s, ``("batch", "kv_seq", None)``: a rank
  holds rows [r·S/m, (r+1)·S/m) of it where m divides S
  (:func:`latent_part`).  Prefill keeps the prompt's rows of this rank.
  Decode writes the new row on the rank that holds its slot, attends in
  latent space with every head (the rank's query latents all-gathered
  over heads when they are sharded) against its rows under the global
  validity rule, giving a float32 output normalised within its rows and
  its log-sum-exp, and one all-gather of (out, lse) feeds the combine in
  rank order (``decode_attention.ops.combine_partials``), the same on
  every rank; each rank then keeps its heads for ``wv_b`` and ``wo``.
  These are torch ops, as ``repro`` computes them in jnp.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.dist.collectives import copy_to_model, model_all_gather, reduce_from_model
from repro_torch.dist.sharding import model_axis, safe_spec
from repro_torch.kernels.decode_attention.ops import combine_partials
from repro_torch.models.attention import KVPart, full_attention, gather_heads, kv_cache_update, write_owned
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import RMSNorm, apply_rope, make_params, sharded_axis
from repro_torch.models.param import ParamDef

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
        self.axis = model_axis()  # the mesh's model axis, whether or not it shards the heads
        self.tp = sharded_axis(defs["wq_b"], 1)  # heads sharded: a tensor-parallel region


def latent_part(cfg: ArchConfig, seq_len: int, axis) -> Optional[KVPart]:
    """Where this rank's latent cache of ``seq_len`` global rows lies on
    ``axis`` (a ``ModelAxis``; None off one) under ``safe_spec`` of
    :func:`mla_cache_defs`: rows from ``offset`` (``"seq"``) or all of
    them (``"whole"``, m does not divide the rows)."""
    if axis is None:
        return None
    d = mla_cache_defs(cfg, 1, seq_len)["c_kv"]
    if safe_spec(d.shape, d.axes, mesh=axis.mesh)[1] is not None:
        return KVPart("seq", axis.rank * (seq_len // axis.size), seq_len)
    return KVPart("whole", 0, seq_len)


def _region(p: MLA, t: torch.Tensor) -> torch.Tensor:
    """A replicated latent as the tensor-parallel region takes it: its
    gradient summed over ``model`` when the heads are sharded."""
    return t if p.tp is None else copy_to_model(t, p.tp.group)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., r) @ w (r, H, k) → (..., H, k)."""
    r, H, k = w.shape
    return (x @ w.reshape(r, H * k)).reshape(*x.shape[:-1], H, k)


def _project_q(p: MLA, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    """→ q_nope, q_rope (B, L, heads, ·) of this rank's heads."""
    m = cfg.mla
    q = _heads(_region(p, p.q_norm(x @ p.wq_a)), p.wq_b)
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
    c_in = _region(p, c_kv)
    k_nope = _heads(c_in, p.wk_b)
    v = _heads(c_in, p.wv_b)
    k_rope_h = _region(p, k_rope)[:, :, None, :].expand(*k_nope.shape[:3], m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    out = full_attention(q, k, v, causal=causal, window=cfg.attn_window)
    y = _out_project(p, out)
    if not want_cache:
        return y, None
    part = latent_part(cfg, x.shape[1], p.axis)
    if part is not None and part.mode == "seq":  # copies: a view would hold every row's storage
        n = part.seq_len // p.axis.size
        c_kv, k_rope = (t[:, part.offset:part.offset + n].clone(memory_format=torch.contiguous_format)
                        for t in (c_kv, k_rope))
    return y, {"c_kv": c_kv, "k_rope": k_rope}


def _out_project(p: MLA, out: torch.Tensor) -> torch.Tensor:
    """out (..., heads, v) of this rank's heads @ its rows of ``wo`` → (...,
    D), summed over ``model`` when the heads are sharded."""
    H, Dv, D = p.wo.shape
    y = out.reshape(*out.shape[:-2], H * Dv) @ p.wo.reshape(H * Dv, D)
    return y if p.tp is None else reduce_from_model(y, p.tp.group)


def _latent_scores(q_lat: torch.Tensor, q_rope: torch.Tensor, c32: torch.Tensor, r_cache: torch.Tensor,
                   cfg: ArchConfig) -> torch.Tensor:
    """The absorbed scores (B, H, S) in float32: q_lat (B, H, r_kv) against
    the latent rows, q_rope (B, H, d_rope) against the RoPE keys."""
    m = cfg.mla
    s = torch.einsum("bhr,bsr->bhs", q_lat.float(), c32)
    s = s + torch.einsum("bhk,bsk->bhs", q_rope.float(), r_cache.float())
    return s / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)


def _latent_attention(p: MLA, q_lat: torch.Tensor, q_rope: torch.Tensor, c_cache: torch.Tensor,
                      r_cache: torch.Tensor, pos: torch.Tensor, cfg: ArchConfig, part: Optional[KVPart]):
    """Attention in latent space → (B, heads, r_kv) float32 of this rank's
    heads: the rank's query latents against its rows of the cache (all of
    it unless ``part`` is ``"seq"``), normalised within them.  On a
    sequence-sharded cache every head attends (the query latents
    all-gathered over heads where they are sharded) and one all-gather of
    (out, its log-sum-exp) feeds the combine over ``model`` (module
    docstring)."""
    seq = part is not None and part.mode == "seq"
    if seq and p.tp is not None:  # every head's query latents on every rank
        r = q_lat.shape[-1]
        qq = gather_heads([torch.cat([q_lat, q_rope], dim=-1)], p.tp.group)[0]
        q_lat, q_rope = qq[..., :r], qq[..., r:]
    c32 = c_cache.float()
    S = c32.shape[1]
    s = _latent_scores(q_lat, q_rope, c32, r_cache, cfg)
    valid = (part.offset if seq else 0) + torch.arange(S, device=pos.device)[None, :] <= pos[:, None]
    s = torch.where(valid[:, None, :], s, torch.full((), -math.inf, device=s.device))
    mx = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx)))
    den = e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhs,bsr->bhr", e, c32) / torch.where(den > 0, den, torch.ones_like(den))
    if not seq:
        return out
    lse = torch.where(den > 0, mx + torch.log(den), torch.full((), -math.inf, device=s.device))
    r = out.shape[-1]
    got = model_all_gather(torch.cat([out, lse], dim=-1), p.axis.group)  # (m, B, H, r + 1)
    lat = combine_partials(got[..., :r][:, :, None], got[..., r])[:, 0]
    if p.tp is not None:  # this rank's heads, for its rows of wv_b and wo
        hl = p.wv_b.shape[1]
        lat = lat[:, p.tp.rank * hl:(p.tp.rank + 1) * hl]
    return lat


def mla_decode_step(p: MLA, x: torch.Tensor, cache: dict, pos: torch.Tensor, cfg: ArchConfig,
                    part: Optional[KVPart] = None):
    """Absorbed-matmul decode.  x (B, 1, D); cache {'c_kv': (B, S, r_kv),
    'k_rope': (B, S, d_rope)}, updated in place; pos (B,) int32 — the new
    token's position.  Slots ``<= pos`` are attended.  ``part``: the
    latent cache's place on the ``model`` axis (:func:`latent_part`; None
    off it).  → (y (B, 1, D), cache)."""
    q_nope, q_rope = _project_q(p, x, pos[:, None], cfg)  # (B, 1, heads, ·)
    c_kv_new, k_rope_new = _project_kv_latent(p, x, pos[:, None], cfg)
    # absorb W_UK into q: q_lat (B, heads, r_kv)
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], p.wk_b)
    if part is not None and part.mode == "seq":
        c_cache, r_cache = cache["c_kv"], cache["k_rope"]
        write_owned(c_cache, c_kv_new, pos - part.offset)
        write_owned(r_cache, k_rope_new, pos - part.offset)
    else:
        c_cache = kv_cache_update(cache["c_kv"], c_kv_new, pos)
        r_cache = kv_cache_update(cache["k_rope"], k_rope_new, pos)
    lat_out = _latent_attention(p, q_lat, q_rope[:, 0], c_cache, r_cache, pos, cfg, part)
    v_out = torch.einsum("bhr,rhv->bhv", lat_out.to(x.dtype), p.wv_b)
    return _out_project(p, v_out)[:, None], cache
