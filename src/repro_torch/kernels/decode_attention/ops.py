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
kernel or raises; ``meta`` tensors take the meta route (``dispatch``): the
output alone, and :func:`flops` over every slot.

The partial route (``partial=True``) serves a sequence-sharded cache: the
cache given is a slice of the global one whose slot 0 is global slot
``slot_offset``, and the call returns the slice's output in float32,
normalised within the slice, and its log-sum-exp (B, H) (``-inf`` where the
slice holds no valid slot, whose output is then 0), so a caller combines
the slices as the kernel combines its chunks (:func:`combine_partials`).
The same kernel and launch: its last chunk writes lse = M + log L of the
(M, L) it forms anyway, and skips the cast.

Head dims above 256 take the *wide route* (``csrc/decode_attention_wide.cu``,
both the full and the partial route), chosen by :func:`route` before any
launch: the same work list, chunks and in-launch combine, with nothing held
a head dim wide in shared memory; counted apart (:data:`wide_launches`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.api import sp_task
from repro_torch.kernels import dispatch

from .ref import decode_attention_ref

#: launches of the kernel through :func:`decode_attention` (``.count``)
launches = dispatch.LaunchCounter()
#: launches of the wide route (``csrc/decode_attention_wide.cu``)
wide_launches = dispatch.LaunchCounter()

#: the widest head dim of ``decode_attention.cu`` (its tiles pad to 128 or
#: 256); wider heads take the wide route
MAIN_MAX_HEAD_DIM = 256
#: cache slots per block (``decode_attention_chunk()`` of the kernel)
CHUNK = 64

# ticket counters of the in-launch combine, one buffer per (card, stream):
# each call leaves them at 0, and calls on one stream run in order
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def chunk_plan(pos, S: int, slot_offset: int = 0) -> list[list[tuple[int, int]]]:
    """The slot ranges ``[start, end)`` the kernel's blocks take for each
    sequence, as it indexes them (slots of the cache given): 64-slot chunks
    from slot 0 up to ``min(pos[b] + 1 - slot_offset, S)``.  A function of
    ``pos[b]``, ``S`` and the slice's offset alone, so a sequence's split
    (and so its output) does not depend on the batch."""
    plan = []
    for p in pos:
        n_valid = min(int(p) + 1 - slot_offset, S)
        plan.append([(s0, min(s0 + CHUNK, n_valid)) for s0 in range(0, max(n_valid, 0), CHUNK)])
    return plan


def work_list(pos, S: int, KH: int, slot_offset: int = 0) -> list[tuple[int, int, int]]:
    """The (sequence, chunk, KV head) items of the kernel's work list, in
    its order (block i takes item i): sequence by sequence, chunk-major, KV
    head fastest.  A sequence with no valid slot (pos < 0, or a slice past
    pos) has one item per KV head, which writes zeros (and lse -inf)."""
    return [
        (b, c, kh)
        for b, chunks in enumerate(chunk_plan(pos, S, slot_offset))
        for c in range(max(len(chunks), 1))
        for kh in range(KH)
    ]


#: threads of a wide-route block (``decode_attention_wide.cu``'s NT)
WIDE_THREADS = 128


def wide_columns(Dv: int) -> list[range]:
    """The head-dim columns each thread of a wide-route block takes in the
    chunk's P·V pass and in the combine: thread t takes t, t + 128, ...
    (each summing the chunk's slots, or the chunks, in order)."""
    return [range(t, Dv, WIDE_THREADS) for t in range(WIDE_THREADS)]


def route(Dh: int, Dv: int) -> str:
    """The route a call takes, by shape, before any launch: ``"main"``
    (``decode_attention.cu``, head dims up to 256) or ``"wide"``."""
    return "wide" if Dh > MAIN_MAX_HEAD_DIM or Dv > MAIN_MAX_HEAD_DIM else "main"


def _ticket_buffer(n: int, device: torch.device, stream: int) -> torch.Tensor:
    if torch.cuda.is_current_stream_capturing():
        # a graph replays the zeroing with the kernel; nothing is cached
        return torch.zeros(n, dtype=torch.int32, device=device)
    key = (device.index if device.index is not None else torch.cuda.current_device(), stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = _tickets[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf


def flops(B: int, n_valid: int, H: int, Dh: int, Dv: int) -> int:
    """Operations of one call over ``n_valid`` valid slots a sequence (the
    scores at Dh, the weighted values at Dv).  The meta route cannot read
    ``pos`` and counts every slot of the cache: the most a call can need."""
    return 2 * B * n_valid * H * (Dh + Dv)


def combine_partials(out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Slices' partial-route results → the whole cache's output: ``out``
    (n, B, 1, H, Dv) and ``lse`` (n, B, H), float32, slice by slice in
    slot order; each slice weighted by exp(lse - max lse), summed in slice
    order, divided by the weights' sum.  A slice with lse -inf weighs 0; a
    row with no valid slot anywhere gives 0, never NaN."""
    M = lse.amax(dim=0)
    M = torch.where(torch.isfinite(M), M, torch.zeros_like(M))
    w = torch.exp(lse - M)[..., None, :, None]  # (n, B, 1, H, 1)
    num, den = out[0] * w[0], w[0]
    for i in range(1, out.shape[0]):
        num = num + out[i] * w[i]
        den = den + w[i]
    return num / torch.where(den > 0, den, torch.ones_like(den))


def decode_attention(
    q: torch.Tensor,        # (B, 1, H, Dh) — model layout
    k_cache: torch.Tensor,  # (B, S, KH, Dh)
    v_cache: torch.Tensor,  # (B, S, KH, Dv)
    pos: torch.Tensor,      # (B,) int32: slots < min(pos + 1 - slot_offset, S) are valid
    slot_offset: int = 0,
    partial: bool = False,
):
    """One-token attention against a KV cache → out (B, 1, H, Dv) in q's
    dtype; with ``partial`` the cache is the slice from global slot
    ``slot_offset`` and the result is (out (B, 1, H, Dv) float32, lse (B, H)
    float32) (module docstring)."""
    tensors = (q, k_cache, v_cache, pos)
    if all(t.device.type == "cpu" for t in tensors):
        return decode_attention_ref(q, k_cache, v_cache, pos, slot_offset, partial)
    meta = dispatch.check_kernel_tensors("decode_attention", *tensors)
    B, one, H, Dh = q.shape
    Bk, S, KH, Dk = k_cache.shape
    Dv = v_cache.shape[-1]
    if one != 1 or (Bk, Dk) != (B, Dh) or tuple(v_cache.shape[:3]) != (B, S, KH) or H % KH:
        raise ValueError(
            f"decode_attention: shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
            f"v {tuple(v_cache.shape)} do not fit (B, 1, H, D) / (B, S, KH, D)"
        )
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
    key = (B, S, H, KH, Dh, Dv) + (("partial",) if partial else ())
    out = torch.empty((B, H, Dv), dtype=torch.float32 if partial else q.dtype, device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if partial else None
    if meta:
        dispatch.meta_launch("decode_attention", key, flops(B, S, H, Dh, Dv))
        return (out[:, None], lse) if partial else out[:, None]
    lib = dispatch.library()
    wide = route(Dh, Dv) == "wide"
    G = H // KH
    n_chunks = -(-S // CHUNK)
    # one workspace: per chunk, G rows of partial sums as wide as the
    # kernel's padded head dim (128 or 256; the wide route's Dv), then G
    # (max, sum)
    row = Dv if wide else lib.decode_attention_padded_dim(Dh, Dv)
    ws = torch.empty(B * KH * n_chunks * G * (row + 2), dtype=torch.float32, device=q.device)
    stream = dispatch.stream_handle(q)
    tickets = _ticket_buffer(B * KH, q.device, stream)
    rc = (lib.decode_attention_wide_fwd if wide else lib.decode_attention_fwd)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), lse.data_ptr() if partial else None, ws.data_ptr(), tickets.data_ptr(),
        B, H, KH, S, Dh, Dv, n_chunks, int(slot_offset),
        dispatch.strides(q, (0, 2)), dispatch.strides(k_cache, (0, 1, 2)),
        dispatch.strides(v_cache, (0, 1, 2)), dispatch.strides(out, (0, 1)),
        1.0 / math.sqrt(Dh), code, stream,
    )
    dispatch.check(rc, "decode_attention")
    (wide_launches if wide else launches).add(key)
    return (out[:, None], lse) if partial else out[:, None]


# -- codelet registration (SpCpu/SpCuda selection, paper §4.3) ---------------

@sp_task(read=("q", "k_cache", "v_cache", "pos"), write=("out",), name="decode_attention")
def decode_attention_codelet(q, k_cache, v_cache, pos, out):
    out.value = decode_attention_ref(q, k_cache, v_cache, pos)


@decode_attention_codelet.impl("cuda", available=dispatch.cuda_available)
def _decode_attention_cuda_impl(q, k_cache, v_cache, pos, out):
    out.value = decode_attention(q, k_cache, v_cache, pos)
