"""Wrappers for the flash-attention kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``, ``csrc/flash_attention_wide.cu``) and the
autograd function over them.

The forward replaces
``src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas``.
At prefill lengths the work is bound by operations (~4·L²·H·Dh/2 flops for
~4·L·H·Dh elements moved).  Two routes, chosen by :func:`route` before any
launch, each counted apart:

- the *main* route, bfloat16 at head dims up to 256 whose bases, head dims
  and strides are whole 16-byte chunks (the serving and train paths): the
  tensor cores (``wgmma``), 128 queries per block over 64-key tiles that
  arrive by 16-byte asynchronous copies (:data:`launches`,
  :data:`bwd_launches`);
- the *wide* route, every other shape: every float32 shape, and bfloat16
  above a head dim of 256 or off the 16-byte grid
  (``csrc/flash_attention_wide.cu``): SIMT, float32 accumulation, any width
  (:data:`wide_launches`, :data:`wide_bwd_launches`; launch plans
  :func:`wide_fwd_plan`, :func:`wide_bwd_plan`).

Both never load a tile that the causal diagonal or the window masks out,
and read the model's (B, L, H, D) layout through strides, so nothing is
transposed.  A CPU tensor takes the plain version in ``ref.py``; a CUDA
tensor launches a kernel or raises; ``meta`` tensors take the meta route
(``dispatch``): the outputs alone, and :func:`fwd_flops` /
:func:`bwd_flops` over the :func:`mask_pairs` the mask keeps.

The forward can also return each row's log-sum-exp (``return_lse``), the
residual that :func:`flash_attention_bwd` recomputes the probabilities
from.  The backward has no Pallas counterpart: JAX trains through the jnp
custom VJP of ``repro/models/attention.py::_make_flash``, whose recurrence
both routes compute.  :class:`FlashAttentionFn` ties the two together for
training; serving calls :func:`flash_attention` without it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.api import sp_task
from repro_torch.kernels import dispatch

from .ref import attention_bwd_ref, attention_fwd_ref, attention_ref

#: launches of the main (tensor-core) route through :func:`flash_attention`
#: (``.count``)
launches = dispatch.LaunchCounter()
#: launches of the main route's backward through :func:`flash_attention_bwd`
bwd_launches = dispatch.LaunchCounter()
#: launches of the wide route's forward (``csrc/flash_attention_wide.cu``)
wide_launches = dispatch.LaunchCounter()
#: launches of the wide route's backward
wide_bwd_launches = dispatch.LaunchCounter()

#: the widest head dim of the main route (it pads to 64, 128 or 256); wider
#: heads take the wide route
MAIN_MAX_HEAD_DIM = 256
#: rows of the wide route's tiles, and the output columns of one of its blocks
WIDE_TILE = 64
WIDE_COLS = 256


def meets_tensor_core_layout(**tensors: torch.Tensor) -> bool:
    """Whether the main route's 16-byte copies can read every tensor: its
    base on 16 bytes, and its head dim and its batch, sequence and head
    strides whole multiples of 8 elements."""
    return not any(t.data_ptr() % 16 or t.shape[-1] % 8 or any(t.stride(d) % 8 for d in (0, 1, 2))
                   for t in tensors.values())


def route(Dh: int, Dv: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """The route a call takes, by shape, before any launch: ``"main"``
    (``flash_attention.cu`` / ``flash_attention_bwd.cu``: bfloat16 at head
    dims up to 256 in whole 16-byte chunks, ``aligned``) or ``"wide"``
    (``flash_attention_wide.cu``: every other shape, float32 included)."""
    if dtype != torch.bfloat16 or not aligned:
        return "wide"
    return "main" if Dh <= MAIN_MAX_HEAD_DIM and Dv <= MAIN_MAX_HEAD_DIM else "wide"


def wide_fwd_plan(Lq: int, H: int, Dv: int) -> list[tuple[int, int, int, int]]:
    """The blocks the wide forward launches for one batch row, as the
    kernel indexes them (grid (query tiles, H · slices, B)): (first query
    row, head, first output column, columns), each writing its 64 query
    rows × its slice of Dv; slice 0 of a head also writes lse."""
    n_sl = -(-Dv // WIDE_COLS)
    return [(q0, h, sl * WIDE_COLS, min(WIDE_COLS, Dv - sl * WIDE_COLS))
            for q0 in range(0, Lq, WIDE_TILE) for h in range(H) for sl in range(n_sl)]


def wide_bwd_plan(Lq: int, Lk: int, H: int, KH: int, Dh: int, Dv: int) -> list[tuple[str, int, int, int, int]]:
    """The blocks of the wide backward's dK/dV and dQ kernels for one batch
    row, as they index them: (output, first row, head (KV head for dK /
    dV), first column, columns).  dK/dV: grid (key tiles, KH · (Dh slices
    + Dv slices), B); dQ: grid (query tiles, H · Dh slices, B).  Each
    block owns its 64 rows × its columns of one output."""
    n_dh, n_dv = -(-Dh // WIDE_COLS), -(-Dv // WIDE_COLS)
    plan = []
    for k0 in range(0, Lk, WIDE_TILE):
        for kh in range(KH):
            for sl in range(n_dh + n_dv):
                what, c0 = ("dk", sl * WIDE_COLS) if sl < n_dh else ("dv", (sl - n_dh) * WIDE_COLS)
                plan.append((what, k0, kh, c0, min(WIDE_COLS, (Dh if what == "dk" else Dv) - c0)))
    for q0 in range(0, Lq, WIDE_TILE):
        for h in range(H):
            for sl in range(n_dh):
                plan.append(("dq", q0, h, sl * WIDE_COLS, min(WIDE_COLS, Dh - sl * WIDE_COLS)))
    return plan


def mask_pairs(Lq: int, Lk: int, causal: bool, window: Optional[int], q_offset: int) -> int:
    """(query, key) pairs the mask keeps: the work one (batch, head) needs."""
    qpos = torch.arange(Lq, dtype=torch.int64) + q_offset
    hi = torch.clamp(qpos + 1, max=Lk) if causal else torch.full_like(qpos, Lk)
    lo = torch.clamp(qpos - window + 1, min=0) if window else torch.zeros_like(qpos)
    return int(torch.clamp(hi - lo, min=0).sum())


def fwd_flops(B: int, H: int, Dh: int, Dv: int, pairs: int) -> int:
    """The forward's operations: S = QKᵀ at Dh and O = PV at Dv over the
    kept pairs."""
    return 2 * B * H * (Dh + Dv) * pairs


def bwd_flops(B: int, H: int, Dh: int, Dv: int, pairs: int) -> int:
    """The backward's operations: 5 products over the kept pairs (S, dQ and
    dK at Dh; dP and dV at Dv; the kernels run 7)."""
    return 2 * B * H * (3 * Dh + 2 * Dv) * pairs


def flash_attention(
    q: torch.Tensor,  # (B, Lq, H, Dh) — model layout
    k: torch.Tensor,  # (B, Lk, KH, Dh)
    v: torch.Tensor,  # (B, Lk, KH, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """→ out (B, Lq, H, Dv), or (out, lse (B, H, Lq) float32) with
    ``return_lse``."""
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return attention_fwd_ref(q, k, v, **kw) if return_lse else attention_ref(q, k, v, **kw)
    B, Lq, H, Dh, Lk, KH, Dv, code, meta, wide = _check("flash_attention", q, k, v)
    out = torch.empty((B, Lq, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0 or Lk == 0:
        out.zero_()
        return (out, lse.fill_(-1e30)) if return_lse else out
    if meta:
        dispatch.meta_launch("flash_attention", (B, Lq, Lk, H, KH, Dh, Dv),
                             fwd_flops(B, H, Dh, Dv, mask_pairs(Lq, Lk, causal, window, q_offset)), **kw)
        return (out, lse) if return_lse else out
    lib = dispatch.library()
    rc = (lib.flash_attention_wide_fwd if wide else lib.flash_attention_fwd)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, H, KH, Lq, Lk, Dh, Dv,
        dispatch.strides(q, (0, 1, 2)), dispatch.strides(k, (0, 1, 2)),
        dispatch.strides(v, (0, 1, 2)), dispatch.strides(out, (0, 1, 2)),
        int(causal), -1 if window is None else int(window), int(q_offset),
        1.0 / math.sqrt(Dh), code, dispatch.stream_handle(q),
    )
    dispatch.check(rc, "flash_attention")
    (wide_launches if wide else launches).add((B, Lq, Lk, H, KH, Dh, Dv))
    return (out, lse) if return_lse else out


def _check(name: str, q, k, v, *more):
    """Shapes, dtypes and layouts every route takes; → (B, Lq, H, Dh, Lk,
    KH, Dv, dtype code, meta route, wide route).  ``more``: (name, tensor)
    pairs shaped like the output (out, dout), held to the same rules and
    to the same route."""
    meta = dispatch.check_kernel_tensors(name, q, k, v, *(t for _, t in more))
    B, Lq, H, Dh = q.shape
    Bk, Lk, KH, Dk = k.shape
    Dv = v.shape[-1]
    if (Bk, Dk) != (B, Dh) or tuple(v.shape[:3]) != (B, Lk, KH) or H % KH:
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not fit (B, L, H, D) with H % KH == 0"
        )
    for what, t in more:
        if tuple(t.shape) != (B, Lq, H, Dv):
            raise ValueError(f"{name}: {what} {tuple(t.shape)} is not (B, Lq, H, Dv) = {(B, Lq, H, Dv)}")
    ts = (q, k, v) + tuple(t for _, t in more)
    if any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{name}: mixed dtypes {[t.dtype for t in ts]}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError(f"{name}: the head dim must be contiguous")
    code = dispatch.dtype_code(name, q)
    aligned = q.dtype == torch.bfloat16 and meets_tensor_core_layout(q=q, k=k, v=v, **dict(more))
    return B, Lq, H, Dh, Lk, KH, Dv, code, meta, route(Dh, Dv, q.dtype, aligned) == "wide"


def flash_attention_bwd(
    q: torch.Tensor,  # (B, Lq, H, Dh)
    k: torch.Tensor,  # (B, Lk, KH, Dh)
    v: torch.Tensor,  # (B, Lk, KH, Dv)
    out: torch.Tensor,  # (B, Lq, H, Dv), the forward's output
    lse: torch.Tensor,  # (B, H, Lq) float32, the forward's log-sum-exp
    dout: torch.Tensor,  # (B, Lq, H, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
):
    """→ (dq, dk, dv) in the inputs' dtype, accumulated in float32 without
    atomics (the same bits on every run).  All tensors are read through
    their (batch, sequence, head) strides; the head dim must be contiguous.
    The main route runs on the tensor cores (``wgmma``: a dK/dV kernel per
    key tile and a dQ kernel per query tile, P and dS rounded to bfloat16
    as the forward rounds P) where q, k, v, out and dout meet the forward's
    16-byte rules (:func:`meets_tensor_core_layout`); every other shape,
    float32 included, takes the wide route (:func:`route`)."""
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention_bwd: window must be positive, got {window}")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if all(t.device.type == "cpu" for t in (q, k, v, out, lse, dout)):
        return attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    B, Lq, H, Dh, Lk, KH, Dv, code, meta, wide = _check(
        "flash_attention_bwd", q, k, v, ("out", out), ("dout", dout)
    )
    dispatch.check_kernel_tensors("flash_attention_bwd", q, lse)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Lq) or not lse.is_contiguous():
        raise ValueError(
            f"flash_attention_bwd: lse {tuple(lse.shape)} {lse.dtype} is not a contiguous "
            f"float32 ({B}, {H}, {Lq})"
        )
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    if Lq == 0 or Lk == 0 or B == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if meta:
        dispatch.meta_launch("flash_attention_bwd", (B, Lq, Lk, H, KH, Dh, Dv),
                             bwd_flops(B, H, Dh, Dv, mask_pairs(Lq, Lk, causal, window, q_offset)), **kw)
        return dq, dk, dv
    dvec = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    lib = dispatch.library()
    rc = (lib.flash_attention_wide_bwd if wide else lib.flash_attention_bwd)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, KH, Lq, Lk, Dh, Dv,
        *(dispatch.strides(t, (0, 1, 2)) for t in (q, k, v, out, dout, dq, dk, dv)),
        int(causal), -1 if window is None else int(window), int(q_offset),
        1.0 / math.sqrt(Dh), code, dispatch.stream_handle(q),
    )
    dispatch.check(rc, "flash_attention_bwd")
    (wide_bwd_launches if wide else bwd_launches).add((B, Lq, Lk, H, KH, Dh, Dv))
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel (with its lse),
    and the backward kernel on what it saved.  An autograd ``dout`` that is
    not contiguous (e.g. from a transposed consumer) is made contiguous
    before the backward launch."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse = flash_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset, return_lse=True
        )
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), causal=causal, window=window, q_offset=q_offset
        )
        return dq, dk, dv, None, None, None


def flash_attention_train(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """:func:`flash_attention` that autograd can differentiate."""
    return FlashAttentionFn.apply(q, k, v, causal, window, q_offset)


# -- codelet registration (SpCpu/SpCuda selection, paper §4.3) ---------------

@sp_task(read=("q", "k", "v"), write=("out",), name="flash_attention", cost=10.0)
def flash_attention_codelet(q, k, v, out, *, causal=True, window=None, q_offset=0):
    out.value = attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)


@flash_attention_codelet.impl("cuda", available=dispatch.cuda_available)
def _flash_attention_cuda_impl(q, k, v, out, *, causal=True, window=None, q_offset=0):
    out.value = flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
