"""Serving steps and plumbing: greedy prefill and decode, the serve step of
a decode shape, the speculative verify forward, priming a prefill cache for
decode, and moving one slot's KV rows in and out of the paged pool.  A port
of ``repro.runtime.serve``: PyTorch runs eagerly, so each ``build_*``
returns a plain closure where ``repro``'s jits one.

On a mesh with a ``model`` axis of m > 1 (block kinds ``"attn"``,
``"moe"`` and ``"mla"``, the model built under it) the steps run
tensor-parallel on each rank's parts, as ``repro``'s jitted steps run
under ``param_shardings`` and :func:`cache_shardings`: the caches are each
rank's part of ``repro``'s global caches (``models.MeshCaches``; MLA's
latent cache by rows), the next tokens the argmax over the
whole vocabulary (``models.greedy_tokens``) on every rank.  Where the
batch axes split the rows, a MoE routes over every rank's rows as the
step declares them (``dist.sharding.split_rows``): :func:`build_serve_step`
does from its shape; a caller of the other steps on such rows declares
them itself.
:func:`prime_cache` pads in the global view, which moves rows between the
ranks of a sequence-sharded cache.  The paged-pool plumbing and the serving
engine stay off such an axis, as ``repro``'s engine takes no mesh.

Block payloads are CPU tensors of the cache dtype, not numpy arrays as in
``repro``: numpy has no bfloat16.
"""
from __future__ import annotations

import torch

from repro_torch.dist.collectives import model_all_gather
from repro_torch.dist.sharding import batch_split_axes, current_mesh, model_axis, safe_spec, spec_axes, split_rows
from repro_torch.models.config import ArchConfig, ShapeSpec
from repro_torch.models.layers import greedy_tokens
from repro_torch.models.param import local_shape, sharding_tree
from repro_torch.models.transformer import (
    MeshCaches,
    cache_defs,
    check_model_axis,
    decode_step,
    layer_cfg,
    prefill,
    verify_step,
)


def cache_shardings(cfg: ArchConfig, batch: int, max_seq: int, mesh=None) -> dict:
    """The ``PartitionSpec`` of every decode-cache leaf on ``mesh`` (default:
    the active mesh), ``repro``'s ``cache_shardings``."""
    return sharding_tree(cache_defs(cfg, batch, max_seq), mesh)


def _pad_kv(kv: torch.Tensor, size: int, window) -> torch.Tensor:
    """Place prefill rows (B, T0, ...) into a fresh cache of ``size`` slots.

    Full cache: copy into [0:T0].  Ring cache (windowed): position p lives in
    slot p % size; only the last ``size`` positions matter."""
    B, T0 = kv.shape[:2]
    out = kv.new_zeros((B, size) + tuple(kv.shape[2:]))
    if window is None:
        out[:, :T0] = kv
        return out
    keep = min(size, T0)
    slots = torch.arange(T0 - keep, T0, device=kv.device) % size
    out[:, slots] = kv[:, T0 - keep:]
    return out


def _model_dim(shape, axes, mesh):
    """The dimension ``safe_spec`` shards over the ``model`` axis, or None."""
    spec = safe_spec(shape, axes, mesh=mesh)
    dims = [d for d, entry in enumerate(spec) if "model" in spec_axes(entry)]
    return dims[0] if dims else None


def _whole_on_model(c: torch.Tensor, shape: tuple, axes, tp) -> torch.Tensor:
    """A rank's part of a leaf of global ``shape`` (its batch rows aside)
    → all of it over ``model`` (one all-gather when the axis shards it)."""
    d = _model_dim(shape, axes, tp.mesh)
    want = tuple(n // tp.size if i == d else n for i, n in enumerate(shape))
    if tuple(c.shape[2:]) != want[2:]:
        raise ValueError(f"cache part {tuple(c.shape)} does not fit the global {shape} on a model axis of {tp.size}")
    if d is None:
        return c
    return torch.cat(list(model_all_gather(c, tp.group).unbind(0)), dim=d)


def _model_part(c: torch.Tensor, axes, tp) -> torch.Tensor:
    """This rank's part of a whole leaf (its batch rows aside) under
    ``safe_spec`` on the ``model`` axis ``tp``."""
    d = _model_dim(tuple(c.shape), axes, tp.mesh)
    if d is None:
        return c
    n = c.shape[d] // tp.size
    return c.narrow(d, tp.rank * n, n).clone(memory_format=torch.contiguous_format)  # not a view of the whole


def prime_cache(cfg: ArchConfig, prefill_caches: dict, prompt_len: int, max_seq: int) -> dict:
    """Turn ``prefill(...)``'s stacked caches (sequence axis 2 = the prompt)
    into decode-ready caches of capacity ``max_seq``, as ``repro``'s:
    attention ``k`` / ``v`` (n, B, prompt_len, KH, Dh) into a cache of
    ``max_seq`` rows or, windowed (the hybrid's attention layers), a ring
    of ``min(max_seq, window)`` slots; MLA's latent ``c_kv`` / ``k_rope``
    (n, B, prompt_len, r) into ``max_seq`` rows.  The recurrent leaves
    (ssm ``state`` / ``conv``, rec ``h`` / ``conv``) are already
    decode-ready and pass through.

    On a ``model`` axis of m > 1 the caches are each rank's parts (of the
    prompt's rows in, of ``max_seq``'s out: a ``MeshCaches``) and the
    padding is the global one: each leaf is put together over ``model``,
    padded, and this rank's part of the result kept."""
    W = layer_cfg(cfg).attn_window
    sizes = {"k": min(max_seq, W) if W is not None else max_seq, "c_kv": max_seq}
    sizes.update(v=sizes["k"], k_rope=max_seq)
    tp = model_axis(current_mesh())
    if tp is not None:
        check_model_axis(cfg)
    out = {}
    for name, c in prefill_caches.items():
        if name not in sizes:
            out[name] = c
            continue
        n_layers, B = c.shape[:2]
        d = cache_defs(cfg, 1, prompt_len)[name]  # the leaf's axes and row shape
        if tp is not None:
            c = _whole_on_model(c, (n_layers, B, prompt_len) + tuple(d.shape[3:]), d.axes, tp)
        if c.shape[2] != prompt_len:
            raise ValueError(f"cache {name}: {c.shape[2]} rows, prompt of {prompt_len}")
        window = W if name in ("k", "v") else None
        flat = _pad_kv(c.reshape((n_layers * B,) + tuple(c.shape[2:])), sizes[name], window)
        c = flat.reshape((n_layers, B) + tuple(flat.shape[1:]))
        out[name] = c if tp is None else _model_part(c, d.axes, tp)
    return out if tp is None else MeshCaches(out, sizes["k"])


# ---------------------------------------------------------------------------
# Paged-cache row plumbing (serving tier): stacked caches with axis 0 =
# layer, 1 = batch slot, 2 = sequence row (``models.cache_layout``).
# ---------------------------------------------------------------------------

def extract_cache_rows(caches: dict, slot: int, start: int, stop: int) -> dict:
    """Copy rows ``[start:stop)`` of one batch slot out of every cache leaf
    into CPU tensors — the payload stored on a KV block at writeback."""
    return {k: v[:, slot, start:stop].to("cpu", copy=True) for k, v in caches.items()}


def insert_cache_rows(caches: dict, slot: int, rows: dict, start: int = 0) -> dict:
    """Write payload ``rows`` (as produced by :func:`extract_cache_rows`,
    possibly concatenated along the row axis) into one batch slot, in place."""
    for k, full in caches.items():
        r = rows[k]
        full[:, slot, start:start + r.shape[1]] = r.to(device=full.device, dtype=full.dtype)
    return caches


def concat_cache_rows(payloads: list) -> dict:
    """Concatenate per-block payloads (ordered) along the row axis."""
    if len(payloads) == 1:
        return payloads[0]
    return {k: torch.cat([p[k] for p in payloads], dim=1) for k in payloads[0]}


def build_prefill_fn(cfg: ArchConfig):
    """(model, batch) → (next tokens (B, 1) int32, the greedy argmax of the
    last position, caches): ``repro``'s ``prefill_fn``."""
    def prefill_fn(model, batch):
        logits, caches = prefill(model, batch, cfg)
        return greedy_tokens(model, logits), caches

    return prefill_fn


def build_decode_fn(cfg: ArchConfig):
    """(model, tokens (B, 1), caches, pos) → (next tokens (B, 1) int32,
    caches updated in place): ``repro``'s greedy ``decode_fn``."""
    def decode_fn(model, tokens, caches, pos):
        logits, caches = decode_step(model, tokens, caches, pos, cfg)
        return greedy_tokens(model, logits), caches

    return decode_fn


def build_serve_step(cfg: ArchConfig, shape: ShapeSpec):
    """The serve step of a decode shape: :func:`build_decode_fn`'s, which
    takes caches of ``shape``'s global batch and rows as this rank's parts
    on the active mesh (:func:`cache_shardings`, as ``repro``'s jitted step
    takes them) and raises on any other.  It declares its rows' split of
    the global batch (``dist.sharding.split_rows``), which a MoE routes
    over."""
    decode_fn = build_decode_fn(cfg)
    mesh = current_mesh()
    want = {name: local_shape(d.shape, safe_spec(d.shape, d.axes, mesh=mesh), mesh) if mesh is not None
            else tuple(d.shape) for name, d in cache_defs(cfg, shape.global_batch, shape.seq_len).items()}
    split = batch_split_axes(shape.global_batch, mesh)

    def serve_step(model, tokens, caches, pos):
        got = {name: tuple(t.shape) for name, t in caches.items()}
        if got != want:
            raise ValueError(f"serve step of {shape.name}: caches {got}, expected this rank's parts {want}")
        with split_rows(split):
            return decode_fn(model, tokens, caches, pos)

    return serve_step


def build_verify_fn(cfg: ArchConfig):
    """Speculative-decoding verify forward: (model, tokens (B, T), caches,
    pos (B,), advance (B,)) → (logits (B, T, V), caches, updated in place):
    :func:`repro_torch.models.verify_step`'s unrolled ``decode_step``, on a
    ``model`` axis too (each position's logits this rank's vocab part)."""
    def verify_fn(model, tokens, caches, pos, advance):
        return verify_step(model, tokens, caches, pos, cfg, advance=advance)

    return verify_fn
