"""Wrapper for the decode-attention kernel (``csrc/decode_attention.cu``).

Replaces ``src/repro/kernels/decode_attention/kernel.py::decode_attention_pallas``
and closes its gap: the TPU kernel takes a scalar ``pos``, the serve engine
needs one position per sequence, so this takes a ``(B,)`` int32 tensor on the
card.  The work is bound by device-memory bytes (each valid K/V row is read
once); the kernel splits the cache into 64-slot chunks across blocks so a
small batch still fills the card, skips chunks past ``pos[b]``, and combines
the chunks in a fixed order with no atomics, so decode is deterministic.  It
reads the cache in the model's (B, S, KH, D) layout through strides.  A CPU
tensor takes the plain version in ``ref.py``; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.api import sp_task
from repro_torch.kernels import dispatch

from .ref import decode_attention_ref

#: launches of the kernel through :func:`decode_attention` (``.count``)
launches = dispatch.LaunchCounter()

_MAX_HEAD_DIM = 128


def decode_attention(
    q: torch.Tensor,        # (B, 1, H, Dh) — model layout
    k_cache: torch.Tensor,  # (B, S, KH, Dh)
    v_cache: torch.Tensor,  # (B, S, KH, Dv)
    pos: torch.Tensor,      # (B,) int32: slots < min(pos + 1, S) are valid
) -> torch.Tensor:
    tensors = (q, k_cache, v_cache, pos)
    if all(t.device.type == "cpu" for t in tensors):
        return decode_attention_ref(q, k_cache, v_cache, pos)
    dispatch.check_cuda_tensors("decode_attention", *tensors)
    B, one, H, Dh = q.shape
    Bk, S, KH, Dk = k_cache.shape
    Dv = v_cache.shape[-1]
    if one != 1 or (Bk, Dk) != (B, Dh) or tuple(v_cache.shape[:3]) != (B, S, KH) or H % KH:
        raise ValueError(
            f"decode_attention: shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
            f"v {tuple(v_cache.shape)} do not fit (B, 1, H, D) / (B, S, KH, D)"
        )
    if Dh > _MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {Dh} exceeds {_MAX_HEAD_DIM}")
    if tuple(pos.shape) != (B,) or pos.dtype != torch.int32 or not pos.is_contiguous():
        raise ValueError(
            f"decode_attention: pos must be a contiguous ({B},) int32 tensor, "
            f"got {tuple(pos.shape)} {pos.dtype}"
        )
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(
            f"decode_attention: mixed dtypes {q.dtype}, {k_cache.dtype}, {v_cache.dtype}"
        )
    if q.stride(-1) != 1 or k_cache.stride(-1) != 1 or v_cache.stride(-1) != 1:
        raise ValueError("decode_attention: the head dim must be contiguous")
    code = dispatch.dtype_code("decode_attention", q)
    lib = dispatch.library()
    G = H // KH
    n_chunks = -(-S // lib.decode_attention_chunk())
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    ws_m = torch.empty((B, KH, n_chunks, G), dtype=torch.float32, device=q.device)
    ws_l = torch.empty_like(ws_m)
    ws_acc = torch.empty((B, KH, n_chunks, G, Dv), dtype=torch.float32, device=q.device)
    rc = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), ws_m.data_ptr(), ws_l.data_ptr(), ws_acc.data_ptr(),
        B, H, KH, S, Dh, Dv, n_chunks,
        dispatch.strides(q, (0, 2)), dispatch.strides(k_cache, (0, 1, 2)),
        dispatch.strides(v_cache, (0, 1, 2)), dispatch.strides(out, (0, 1)),
        1.0 / math.sqrt(Dh), code, dispatch.stream_handle(q),
    )
    dispatch.check(rc, "decode_attention")
    launches.add()
    return out[:, None]


# -- codelet registration (SpCpu/SpCuda selection, paper §4.3) ---------------

@sp_task(read=("q", "k_cache", "v_cache", "pos"), write=("out",), name="decode_attention")
def decode_attention_codelet(q, k_cache, v_cache, pos, out):
    out.value = decode_attention_ref(q, k_cache, v_cache, pos)


@decode_attention_codelet.impl("cuda", available=dispatch.cuda_available)
def _decode_attention_cuda_impl(q, k_cache, v_cache, pos, out):
    out.value = decode_attention(q, k_cache, v_cache, pos)
