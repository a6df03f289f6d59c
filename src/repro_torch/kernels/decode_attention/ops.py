"""Wrapper for the decode-attention kernel (``csrc/decode_attention.cu``).

Replaces ``src/repro/kernels/decode_attention/kernel.py::decode_attention_pallas``
and closes its gap: the TPU kernel takes a scalar ``pos``, the serve engine
needs one position per sequence, so this takes a ``(B,)`` int32 tensor on the
card.  The work is bound by device-memory bytes (each valid K/V row is read
once).  One launch: a block per 64-slot chunk of the valid slots (so a
small batch still fills the card; :func:`work_list`) issues all of its
chunk's loads at once, and the last chunk of each (sequence, KV head) to
finish combines the chunks in a fixed order, so decode is deterministic and
each sequence's output depends on its own position only
(:func:`chunk_plan`).
It reads the cache in the model's (B, S, KH, D) layout through strides.  A
CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches the
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
#: cache slots per block (``decode_attention_chunk()`` of the kernel)
CHUNK = 64

# ticket counters of the in-launch combine, one buffer per (card, stream):
# each call leaves them at 0, and calls on one stream run in order
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def chunk_plan(pos, S: int) -> list[list[tuple[int, int]]]:
    """The slot ranges ``[start, end)`` the kernel's blocks take for each
    sequence, as it indexes them: 64-slot chunks from slot 0 up to
    ``min(pos[b] + 1, S)``.  A function of ``pos[b]`` and ``S`` alone, so a
    sequence's split (and so its output) does not depend on the batch."""
    plan = []
    for p in pos:
        n_valid = min(int(p) + 1, S)
        plan.append([(s0, min(s0 + CHUNK, n_valid)) for s0 in range(0, max(n_valid, 0), CHUNK)])
    return plan


def work_list(pos, S: int, KH: int) -> list[tuple[int, int, int]]:
    """The (sequence, chunk, KV head) items of the kernel's work list, in
    its order (block i takes item i): sequence by sequence, chunk-major, KV
    head fastest.  A sequence with no valid slot (pos < 0) has one item per
    KV head, which writes zeros."""
    return [
        (b, c, kh)
        for b, chunks in enumerate(chunk_plan(pos, S))
        for c in range(max(len(chunks), 1))
        for kh in range(KH)
    ]


def _ticket_buffer(n: int, device: torch.device, stream: int) -> torch.Tensor:
    if torch.cuda.is_current_stream_capturing():
        # a graph replays the zeroing with the kernel; nothing is cached
        return torch.zeros(n, dtype=torch.int32, device=device)
    key = (device.index if device.index is not None else torch.cuda.current_device(), stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = _tickets[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf


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
    if Dh > _MAX_HEAD_DIM or Dv > _MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head dims {Dh}/{Dv} exceed {_MAX_HEAD_DIM}")
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
    n_chunks = -(-S // CHUNK)
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    # one workspace: per chunk, G rows of 128 partial sums, then G (max, sum)
    ws = torch.empty(B * KH * n_chunks * G * (_MAX_HEAD_DIM + 2), dtype=torch.float32, device=q.device)
    stream = dispatch.stream_handle(q)
    tickets = _ticket_buffer(B * KH, q.device, stream)
    rc = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
        B, H, KH, S, Dh, Dv, n_chunks,
        dispatch.strides(q, (0, 2)), dispatch.strides(k_cache, (0, 1, 2)),
        dispatch.strides(v_cache, (0, 1, 2)), dispatch.strides(out, (0, 1)),
        1.0 / math.sqrt(Dh), code, stream,
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
