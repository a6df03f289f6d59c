"""Wrapper for the flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas``.
At prefill lengths the work is bound by operations (~4·L²·H·Dh/2 flops for
~4·L·H·Dh elements moved).  bfloat16 runs on the tensor cores (``wgmma``),
128 queries per block over 64-key tiles that arrive by 16-byte asynchronous
copies; float32 runs on the SIMT cores.  Both never load a tile that the
causal diagonal or the window masks out, and read the model's (B, L, H, D)
layout through strides, so nothing is transposed.  A CPU tensor takes the
plain version in ``ref.py``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.api import sp_task
from repro_torch.kernels import dispatch

from .ref import attention_ref

#: launches of the kernel through :func:`flash_attention` (``.count``)
launches = dispatch.LaunchCounter()

_MAX_HEAD_DIM = 128


def check_tensor_core_layout(**tensors: torch.Tensor) -> None:
    """The bfloat16 kernel copies 16-byte chunks: each tensor's base must lie
    on 16 bytes, and its head dim and its batch, sequence and head strides
    must be whole multiples of 8 elements.  Raises ``ValueError`` otherwise."""
    for name, t in tensors.items():
        bad = [d for d in (0, 1, 2) if t.stride(d) % 8]
        if t.data_ptr() % 16 or t.shape[-1] % 8 or bad:
            raise ValueError(
                f"flash_attention: bfloat16 {name} {tuple(t.shape)} with strides {t.stride()} "
                f"at offset {t.data_ptr() % 16} mod 16 bytes: the tensor-core kernel needs a "
                "16-byte-aligned base and a head dim and (batch, sequence, head) strides "
                "that are multiples of 8 elements"
            )


def flash_attention(
    q: torch.Tensor,  # (B, Lq, H, Dh) — model layout
    k: torch.Tensor,  # (B, Lk, KH, Dh)
    v: torch.Tensor,  # (B, Lk, KH, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    dispatch.check_cuda_tensors("flash_attention", q, k, v)
    B, Lq, H, Dh = q.shape
    Bk, Lk, KH, Dk = k.shape
    Dv = v.shape[-1]
    if (Bk, Dk) != (B, Dh) or tuple(v.shape[:3]) != (B, Lk, KH) or H % KH:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not fit (B, L, H, D) with H % KH == 0"
        )
    if Dh > _MAX_HEAD_DIM or Dv > _MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dims {Dh}/{Dv} exceed {_MAX_HEAD_DIM}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    code = dispatch.dtype_code("flash_attention", q)
    if q.dtype == torch.bfloat16:
        check_tensor_core_layout(q=q, k=k, v=v)
    out = torch.empty((B, Lq, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or Lk == 0:
        return out.zero_()
    lib = dispatch.library()
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, KH, Lq, Lk, Dh, Dv,
        dispatch.strides(q, (0, 1, 2)), dispatch.strides(k, (0, 1, 2)),
        dispatch.strides(v, (0, 1, 2)), dispatch.strides(out, (0, 1, 2)),
        int(causal), -1 if window is None else int(window), int(q_offset),
        1.0 / math.sqrt(Dh), code, dispatch.stream_handle(q),
    )
    dispatch.check(rc, "flash_attention")
    launches.add()
    return out


# -- codelet registration (SpCpu/SpCuda selection, paper §4.3) ---------------

@sp_task(read=("q", "k", "v"), write=("out",), name="flash_attention", cost=10.0)
def flash_attention_codelet(q, k, v, out, *, causal=True, window=None, q_offset=0):
    out.value = attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)


@flash_attention_codelet.impl("cuda", available=dispatch.cuda_available)
def _flash_attention_cuda_impl(q, k, v, out, *, causal=True, window=None, q_offset=0):
    out.value = flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
