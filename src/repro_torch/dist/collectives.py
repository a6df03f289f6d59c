"""Gradient compression with error feedback: the compression part of
``repro.dist.collectives`` (``compress_int8`` … ``compress_tree``), on
tensors.  The ring and hierarchical all-reduces around it stay in the JAX
package until the distributed slice (ROADMAP.md, Queue 1 item 5).

Trees are dicts (nested or flat) of tensors; each tensor is one leaf with
its own scale.  :func:`int8_scale` takes several tensors, so a caller that
holds one of ``repro``'s stacked leaves as per-layer tensors quantizes them
with the scale of the whole leaf.
"""
from __future__ import annotations

import torch


def int8_scale(*tensors: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """max|g| / 127 over all ``tensors`` (float32), at least ``eps`` / 127."""
    amax = torch.stack([t.detach().abs().amax().float() for t in tensors]).amax()
    return torch.clamp(amax, min=eps) / 127.0


def compress_int8(g: torch.Tensor, *, eps: float = 1e-8, scale=None):
    """Symmetric per-tensor int8 quantization: ``(q, scale)`` with
    ``q = round(g / scale)`` and ``scale = max|g| / 127`` (or the given
    one).  The round-trip error of every element is bounded by
    ``scale / 2``."""
    g = g.float()
    if scale is None:
        scale = int8_scale(g, eps=eps)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def init_residuals(grads):
    """Zero error-feedback residuals shaped like ``grads`` (float32)."""
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compress_tree(grads, residuals):
    """Quantize-dequantize every leaf with error feedback.

    Returns ``(dequantized, new_residuals)``: the residual (what int8 lost
    this step) is added back before quantizing next step, so the long-run
    mean of the dequantized stream converges to the true gradient.
    """
    def one(g, r):
        corrected = g.float() + r
        deq = decompress_int8(*compress_int8(corrected))
        return deq, corrected - deq

    pairs = _map(one, grads, residuals)
    return _map(lambda p: p[0], pairs), _map(lambda p: p[1], pairs)
