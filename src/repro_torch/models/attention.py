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

On a ``model`` mesh axis of m > 1 (``Attention.axis``) the projections are
tensor-parallel over the local heads (``Attention.tp``, when m divides the
heads), and a rank's KV cache is its part of ``repro``'s global cache under
:func:`kv_cache_axes` (:class:`KVPart`):

* ``"heads"`` — its KV heads (the rank's query heads read them): prefill and
  decode run on the local heads, the training layout;
* ``"seq"`` — rows ``[offset, offset + S/m)`` of every KV head
  (``kv_shard="seq"``, ``repro``'s sequence-sharded cache): decode
  all-gathers the new token's q, k and v over ``model`` (a few KB), the rank
  whose rows hold the slot writes it, each rank attends with every head to
  its rows through the decode kernel's partial route (the global validity
  rule, float32 output and log-sum-exp), and one all-gather of (out, lse)
  feeds a combine in rank order (``decode_attention.ops.combine_partials``),
  the same on every rank; prefill all-gathers K/V over heads and keeps its
  rows;
* ``"whole"`` — the whole cache on every rank (m divides neither the rows
  nor the KV heads): as ``"seq"`` with one slice and no combine.

Each rank then keeps its query heads for the row-parallel ``wo`` and the sum
over ``model``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
from torch import nn

from repro_torch.dist.collectives import copy_to_model, model_all_gather, reduce_from_model
from repro_torch.dist.sharding import model_axis, safe_spec
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import RMSNorm, apply_rope, make_params, rmsnorm, sharded_axis
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


def local_kv_heads(H: int, KH: int, m: int, r: int):
    """The KV heads rank ``r`` of ``m`` reads for its query heads ``[r·H/m,
    (r+1)·H/m)`` (query head h reads KV head h // (H / KH)): a ``slice``
    when they form a block the local heads map onto as GQA does, else a
    list with one KV head per local query head."""
    hl, g = H // m, H // KH
    idx = [h // g for h in range(r * hl, (r + 1) * hl)]
    n = idx[-1] - idx[0] + 1
    if hl % n == 0 and all(i - idx[0] == j // (hl // n) for j, i in enumerate(idx)):
        return slice(idx[0], idx[0] + n)
    return idx


class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype, device):
        super().__init__()
        defs = attn_defs(cfg)
        norms = {k: defs.pop(k) for k in ("q_norm", "k_norm") if k in defs}
        make_params(self, defs, dtype=dtype, device=device)
        for name in norms:
            setattr(self, name, RMSNorm(cfg.head_dim, cfg.norm_eps, dtype=dtype, device=device))
        self.axis = model_axis()  # the mesh's model axis, whether or not it shards the heads
        self.tp = sharded_axis(defs["wq"], 1)  # heads sharded: a tensor-parallel region
        self.kv_sharded = self.tp is not None and sharded_axis(defs["wk"], 1) is not None
        self.heads = (cfg.n_heads, cfg.n_kv_heads)


def partial_grad_names(p: Attention) -> tuple[str, ...]:
    """Parameters (names under ``p``) replicated over ``model`` but used
    inside the tensor-parallel region: each rank's gradient is a part of
    theirs."""
    if p.tp is None:
        return ()
    names = [f"{n}.scale" for n in ("q_norm", "k_norm") if hasattr(p, n)]
    if not p.kv_sharded:
        names += [n for n in ("wk", "wv", "bk", "bv") if hasattr(p, n)]
    return tuple(names)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, L, D) @ w (D, n, Dh) → (B, L, n, Dh)."""
    D, n, Dh = w.shape
    return (x @ w.reshape(D, n * Dh)).reshape(*x.shape[:-1], n, Dh)


def _kv_params(p: Attention, w: torch.Tensor, axis: int, whole: bool = False) -> torch.Tensor:
    """``w`` (a KV weight or bias) restricted to the KV heads this rank
    reads (on axis ``axis``): all of it unless the heads are sharded and
    the KV heads replicated (:func:`local_kv_heads`), or ``whole``."""
    if p.tp is None or p.kv_sharded or whole:
        return w
    sel = local_kv_heads(*p.heads, p.tp.size, p.tp.rank)
    if isinstance(sel, slice):
        return w.narrow(axis, sel.start, sel.stop - sel.start)
    return w.index_select(axis, torch.tensor(sel, device=w.device))


def qkv_project(p: Attention, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                *, whole_kv: bool = False):
    """x (B, L, D) → q (B, L, H, Dh), k/v (B, L, KH, Dh), RoPE applied (the
    local heads under a ``model`` axis; every KV head with ``whole_kv``,
    which replicated KV weights allow)."""
    q = _project(x, p.wq)
    k = _project(x, _kv_params(p, p.wk, 1, whole_kv))
    v = _project(x, _kv_params(p, p.wv, 1, whole_kv))
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + _kv_params(p, p.bk, 0, whole_kv)
        v = v + _kv_params(p, p.bv, 0, whole_kv)
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


def kv_cache_axes(cfg: Optional[ArchConfig] = None) -> tuple:
    """The logical axes of a (B, S, KH, Dh) KV cache: sequence-sharded by
    default, over the KV heads under ``kv_shard="heads"`` (``repro``'s)."""
    if cfg is not None and cfg.kv_shard == "heads":
        return ("batch", None, "kv_heads", None)
    return ("batch", "kv_seq", "kv_heads", None)


class KVPart(NamedTuple):
    """A rank's part of a KV cache on the ``model`` axis (module
    docstring): ``mode`` ``"heads"`` (its KV heads), ``"seq"`` (rows from
    global slot ``offset``) or ``"whole"``; ``seq_len`` is the global
    cache's rows."""

    mode: str
    offset: int
    seq_len: int


def kv_part(cfg: ArchConfig, seq_len: int, axis) -> Optional[KVPart]:
    """Where this rank's KV cache of ``seq_len`` global rows lies under
    ``safe_spec`` of :func:`kv_cache_axes` on ``axis`` (a ``ModelAxis``):
    None off a ``model`` axis.  The spec's first dimension wins: under
    ``kv_shard="seq"`` a cache whose rows m does not divide goes by its KV
    heads, as ``repro``'s does."""
    if axis is None:
        return None
    spec = safe_spec((1, seq_len, cfg.n_kv_heads, cfg.head_dim), kv_cache_axes(cfg), mesh=axis.mesh)
    if spec[1] is not None:
        return KVPart("seq", axis.rank * (seq_len // axis.size), seq_len)
    return KVPart("heads" if spec[2] is not None else "whole", 0, seq_len)


def gather_heads(parts: list, group) -> list:
    """Each tensor of ``parts`` (…, n_i, Dh), a rank's share of the heads,
    whole: one all-gather over ``group`` of the parts packed on the head
    axis, each one's shares then put together in rank order."""
    sizes = [t.shape[-2] for t in parts]
    got = model_all_gather(torch.cat(parts, dim=-2), group)  # (m, ..., sum n_i, Dh)
    return [torch.cat(list(g.unbind(0)), dim=-2) for g in got.split(sizes, dim=-2)]


def cache_part(p: Attention, k: torch.Tensor, v: torch.Tensor, x: torch.Tensor, positions: torch.Tensor,
               cfg: ArchConfig, part: KVPart) -> dict:
    """A prefill's K/V (B, L, ·, Dh) of this rank's heads → its part of
    the cache of the prompt (``part``, of ``L`` rows): its KV heads as
    they are; else every KV head (all-gathered over heads, or projected
    from ``x`` when the KV weights are replicated), all L rows or this
    rank's."""
    if part.mode == "heads":
        return {"k": k, "v": v}
    if p.kv_sharded:
        k, v = gather_heads([k, v], p.axis.group)
    elif p.tp is not None:
        _, k, v = qkv_project(p, x, positions, cfg, whole_kv=True)
    if part.mode == "seq":  # copies: a view would hold every row's storage
        n = part.seq_len // p.axis.size
        k, v = (t[:, part.offset:part.offset + n].clone(memory_format=torch.contiguous_format) for t in (k, v))
    return {"k": k.contiguous(), "v": v.contiguous()}


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


def write_owned(cache: torch.Tensor, new: torch.Tensor, row: torch.Tensor) -> None:
    """Write ``new`` (B, 1, ...) at local row ``row`` (B,) of ``cache``
    where the row lies in it; elsewhere rewrite the row a clamp picks with
    itself (no data-dependent indexing: nothing waits on the card)."""
    S = cache.shape[1]
    owned = (row >= 0) & (row < S)
    idx = row.clamp(0, S - 1).long()
    b = torch.arange(cache.shape[0], device=cache.device)
    keep = cache[b, idx]
    mask = owned.reshape((-1,) + (1,) * (keep.ndim - 1))
    cache[b, idx] = torch.where(mask, new[:, 0].to(cache.dtype), keep)


def _every_head(p: Attention, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    """q (B, L, H, Dh) and k/v (B, L, KH, Dh) of every head on every rank:
    each rank projects its heads and one all-gather over ``model`` puts them
    together (the replicated KV weights project every KV head here)."""
    if p.tp is None:
        return qkv_project(p, x, positions, cfg)
    if p.kv_sharded:
        return tuple(gather_heads(list(qkv_project(p, x, positions, cfg)), p.tp.group))
    q, k, v = qkv_project(p, x, positions, cfg, whole_kv=True)
    return gather_heads([q], p.tp.group)[0], k, v


def _decode_every_head(p: Attention, x: torch.Tensor, cache: dict, pos: torch.Tensor, cfg: ArchConfig,
                       part: KVPart) -> torch.Tensor:
    """Decode attention of every head against this rank's rows (``"seq"``,
    combined over ``model``) or the whole cache (``"whole"``) → out (B, 1,
    H, Dh) in the cache's dtype, the same on every rank."""
    q, k, v = _every_head(p, x, pos[:, None], cfg)
    slot = pos % part.seq_len if cfg.attn_window is not None else pos
    write_owned(cache["k"], k, slot - part.offset)
    write_owned(cache["v"], v, slot - part.offset)
    if part.mode == "whole":
        return decode_attention(q, cache["k"], cache["v"], pos)
    out, lse = decode_ops.decode_attention(q, cache["k"], cache["v"], pos, part.offset, partial=True)
    B, _, H, Dv = out.shape
    got = model_all_gather(torch.cat([out[:, 0], lse[..., None]], dim=-1), p.axis.group)  # (m, B, H, Dv + 1)
    out = decode_ops.combine_partials(got[..., :Dv][:, :, None], got[..., Dv])
    return out.to(q.dtype)


def attention_decode_step(
    p: Attention,
    x: torch.Tensor,
    cache: dict,
    pos: torch.Tensor,
    cfg: ArchConfig,
    part: Optional[KVPart] = None,
):
    """x (B, 1, D) new-token activations; cache {'k', 'v'} (B, S, KH, Dh),
    full or ring, updated in place; pos (B,) int32; ``part`` the cache's
    place on the ``model`` axis (None off it).  → (out (B, 1, D), cache)."""
    if p.tp is not None:
        x = copy_to_model(x, p.tp.group)
    if part is None or part.mode == "heads":
        q, k, v = qkv_project(p, x, pos[:, None], cfg)
        S = cache["k"].shape[1]
        slot = pos % S if cfg.attn_window is not None else pos
        kv_cache_update(cache["k"], k, slot)
        kv_cache_update(cache["v"], v, slot)
        out = decode_attention(q, cache["k"], cache["v"], pos)
    else:
        out = _decode_every_head(p, x, cache, pos, cfg, part)
        if p.tp is not None:  # this rank's query heads, for its rows of wo
            hl = p.wq.shape[1]
            out = out[:, :, p.tp.rank * hl:(p.tp.rank + 1) * hl]
    y = _out_project(out, p.wo)
    if p.tp is not None:
        y = reduce_from_model(y, p.tp.group)
    return y, cache


def attention_apply(
    p: Attention,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ArchConfig,
    *,
    causal: bool = True,
    want_cache: bool = False,
):
    """Prefill attention over the full sequence → (y (B, L, D), {'k','v'} | None);
    tensor-parallel over the local heads when ``p.tp`` is set.  On a
    ``model`` axis the cache is this rank's part of the prompt's
    (:func:`cache_part`)."""
    if p.tp is not None:
        x = copy_to_model(x, p.tp.group)
    q, k, v = qkv_project(p, x, positions, cfg)
    out = full_attention(q, k, v, causal=causal, window=cfg.attn_window)
    y = _out_project(out, p.wo)
    if p.tp is not None:
        y = reduce_from_model(y, p.tp.group)
    if not want_cache:
        return y, None
    part = kv_part(cfg, x.shape[1], p.axis)
    if part is None:
        return y, {"k": k, "v": v}
    return y, cache_part(p, k, v, x, positions, cfg, part)
