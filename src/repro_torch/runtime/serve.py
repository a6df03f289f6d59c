"""Serving plumbing: prime a prefill cache for decode, and move one slot's KV
rows in and out of the paged pool.  A port of ``repro.runtime.serve``
(the jitted ``build_*_fn`` wrappers have no counterpart: PyTorch runs eagerly).

Block payloads are CPU tensors of the cache dtype, not numpy arrays as in
``repro``: numpy has no bfloat16.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig


def _pad_kv(kv: torch.Tensor, size: int, window) -> torch.Tensor:
    """Place prefill K/V (B, T0, KH, Dh) into a fresh cache of ``size`` slots.

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


def prime_cache(cfg: ArchConfig, prefill_caches: dict, prompt_len: int, max_seq: int) -> dict:
    """Turn ``prefill(...)``'s stacked caches (n_layers, B, prompt_len, KH,
    Dh) into decode-ready caches of capacity ``max_seq`` (ring-aware)."""
    W = cfg.attn_window
    size = min(max_seq, W) if W is not None else max_seq
    out = {}
    for name, c in prefill_caches.items():
        if c.shape[2] != prompt_len:
            raise ValueError(f"cache {name}: {c.shape[2]} rows, prompt of {prompt_len}")
        n_layers, B = c.shape[:2]
        flat = _pad_kv(c.reshape((n_layers * B,) + tuple(c.shape[2:])), size, W)
        out[name] = flat.reshape((n_layers, B) + tuple(flat.shape[1:]))
    return out


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
