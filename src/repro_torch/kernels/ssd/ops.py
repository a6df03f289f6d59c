"""Wrapper for the SSD intra-chunk kernel (``csrc/ssd.cu``) and the chunked
SSD scan built on it.

Replaces ``src/repro/kernels/ssd/kernel.py::ssd_intra_chunk_pallas`` and the
scan around it, ``ops.py::ssd_chunked_pallas``.  bfloat16 (the serving path)
runs its three products on the tensor cores (``wgmma``): two blocks per
chunk, each holding the chunk's B and x and two causal 64-row tiles of C in
shared memory, with the f32 decay weights carried as a bf16 hi + lo pair so
the f32 accuracy is kept; float32 runs on the SIMT cores.  Both never
compute the masked triangle, whose decay may be inf, and read the model's
(B, L, H, ·) layout, and B/C by group, through strides, so nothing is
transposed or expanded.  A CPU tensor takes the plain version in ``ref.py``;
a CUDA tensor launches the kernel or raises.

The kernel is forward only: its outputs are written through ctypes, so
autograd sees no path from them back to the inputs.  Until the ssd backward
lands (ROADMAP.md, Queue 2 item 4), the CUDA route refuses inputs that
autograd records (:func:`check_no_autograd`), so training mamba2 on the
card fails at its first microbatch instead of training on wrong gradients.
Serving runs under ``torch.no_grad`` with frozen parameters and is not
affected.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.api import sp_task
from repro_torch.kernels import dispatch

from .ref import ssd_chunk_ref

#: launches of the kernel through :func:`ssd_intra_chunk` (``.count``)
launches = dispatch.LaunchCounter()

_MAX_HEAD_DIM = 64
_MAX_STATE_DIM = 128
#: rows of a tile (i and j) and the longest chunk of the tensor-core route
TILE = 64
TC_MAX_CHUNK = 256


class TcBlock(NamedTuple):
    """The work of one block of the tensor-core route for one chunk."""
    half: int                               # blockIdx.x
    y_tiles: tuple[tuple[int, tuple[int, ...]], ...]  # (i tile, its j tiles)
    state_rows: tuple[int, int]             # [lo, hi) of the N state rows
    state_j_tiles: tuple[int, ...]


def tc_launch_plan(cs: int, N: int = _MAX_STATE_DIM) -> list[TcBlock]:
    """The two blocks ``ssd_chunk_wgmma_kernel`` runs for one chunk of
    ``cs`` rows (its grid is (2, chunks, batch · heads)), as the kernel
    indexes them: block ``half`` takes the causal i tiles ``half`` and
    ``3 - half`` (5 tile products each at cs = 256) and state rows
    ``64·half`` to ``64·half + 64`` over every j tile."""
    n_tiles = -(-cs // TILE)
    plan = []
    for half in (0, 1):
        tiles = tuple((it, tuple(range(it + 1))) for it in (half, 3 - half) if it < n_tiles)
        lo = half * TILE
        rows = (lo, min(lo + TILE, N)) if lo < N else (lo, lo)
        plan.append(TcBlock(half, tiles, rows, tuple(range(n_tiles)) if lo < N else ()))
    return plan


def check_tensor_core_layout(cs: int, **tensors: torch.Tensor) -> None:
    """The bfloat16 kernel holds a chunk of at most 256 rows and copies
    16-byte chunks: each tensor's base must lie on 16 bytes, its last dim
    (P or N) must be a multiple of 8 elements, and every stride of a dim
    with more than one index must be a whole multiple of 8 elements.
    Raises ``ValueError`` otherwise."""
    if cs > TC_MAX_CHUNK:
        raise ValueError(
            f"ssd_intra_chunk: bfloat16 chunk of {cs} rows: the tensor-core kernel takes "
            f"at most {TC_MAX_CHUNK}"
        )
    for name, t in tensors.items():
        bad = [d for d in range(t.ndim - 1) if t.shape[d] > 1 and t.stride(d) % 8]
        if t.data_ptr() % 16 or t.shape[-1] % 8 or bad:
            raise ValueError(
                f"ssd_intra_chunk: bfloat16 {name} {tuple(t.shape)} with strides {t.stride()} "
                f"at offset {t.data_ptr() % 16} mod 16 bytes: the tensor-core kernel needs a "
                "16-byte-aligned base, a last dim and strides that are multiples of 8 elements"
            )


def check_no_autograd(*tensors: torch.Tensor) -> None:
    """Raise ``NotImplementedError`` when autograd records and any of
    ``tensors`` requires grad: the kernel has no backward yet, and its
    outputs would carry no gradient back to them."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "ssd_intra_chunk: the CUDA kernel has no backward yet (ROADMAP.md, Queue 2 item 4: "
            "the ssd backward), so it cannot train: its outputs would carry no gradient to "
            "x, dt, cum, B or C.  Run it under torch.no_grad, or train on the CPU"
        )


def ssd_intra_chunk(x, dt, cum, B, C):
    """The intra-chunk output and the end-of-chunk state of every chunk.

    x (b, H, nc, cs, P); dt, cum (b, H, nc, cs) float32; B, C
    (b, G, nc, cs, N), G | H groups (G = H: one per head; head h reads
    group h // (H // G)).  Any strides with a contiguous last dim.
    → (y (b, H, nc, cs, P), state (b, H, nc, N, P)), both float32.  (The
    plain version also takes the TPU kernel's (BH, nc, cs, ·) layout.)
    Off the CPU, inputs that autograd records raise ``NotImplementedError``
    before anything is checked or launched (:func:`check_no_autograd`).
    """
    tensors = (x, dt, cum, B, C)
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_chunk_ref(x, dt, cum, B, C)
    check_no_autograd(*tensors)
    dispatch.check_cuda_tensors("ssd_intra_chunk", *tensors)
    if x.ndim != 5:
        raise ValueError(f"ssd_intra_chunk: x must be (b, H, nc, cs, P), got {tuple(x.shape)}")
    Bsz, H, nc, cs, P = x.shape
    G, N = B.shape[1], B.shape[-1]
    if (
        tuple(B.shape) != (Bsz, G, nc, cs, N) or C.shape != B.shape
        or tuple(dt.shape) != (Bsz, H, nc, cs) or cum.shape != dt.shape
        or G < 1 or H % G
    ):
        raise ValueError(
            f"ssd_intra_chunk: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, cum "
            f"{tuple(cum.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)} do not fit "
            "(b, H, nc, cs, ·) with B/C on H or on G | H groups"
        )
    if P > _MAX_HEAD_DIM or N > _MAX_STATE_DIM:
        raise ValueError(
            f"ssd_intra_chunk: head dim {P} / state dim {N} exceed {_MAX_HEAD_DIM} / {_MAX_STATE_DIM}"
        )
    if not (x.dtype == B.dtype == C.dtype):
        raise TypeError(f"ssd_intra_chunk: mixed dtypes x {x.dtype}, B {B.dtype}, C {C.dtype}")
    if dt.dtype != torch.float32 or cum.dtype != torch.float32:
        raise TypeError(f"ssd_intra_chunk: dt and cum must be float32, got {dt.dtype}, {cum.dtype}")
    if any(t.shape[-1] > 1 and t.stride(-1) != 1 for t in (x, B, C)):
        raise ValueError("ssd_intra_chunk: the last dim of x, B and C must be contiguous")
    code = dispatch.dtype_code("ssd_intra_chunk", x)
    if x.dtype == torch.bfloat16:
        check_tensor_core_layout(cs, x=x, B=B, C=C)
    # y in the model's (b, nc, cs, H, P) order, seen as (b, H, nc, cs, P)
    y = torch.empty((Bsz, nc, cs, H, P), dtype=torch.float32, device=x.device).permute(0, 3, 1, 2, 4)
    state = torch.empty((Bsz, H, nc, N, P), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, state.zero_()
    lib = dispatch.library()
    dims = (0, 1, 2, 3)
    rc = lib.ssd_intra_chunk_fwd(
        x.data_ptr(), dt.data_ptr(), cum.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), state.data_ptr(), Bsz, H, H // G, nc, cs, P, N,
        dispatch.strides(x, dims), dispatch.strides(dt, dims), dispatch.strides(cum, dims),
        dispatch.strides(B, dims), dispatch.strides(C, dims), dispatch.strides(y, dims),
        dispatch.strides(state, (0, 1, 2)), code, dispatch.stream_handle(x),
    )
    dispatch.check(rc, "ssd_intra_chunk")
    launches.add()
    return y, state


def _chunked(xh, dt, A, Bc, Cc, chunk: int, initial_state, intra):
    Bsz, L, H, P = xh.shape
    G, N = Bc.shape[2], Bc.shape[3]
    L0 = L
    if L % chunk:
        # pad to a chunk multiple with dt = 0: decay exp(0) = 1 and no state
        # update, so the recurrence is unaffected; padded y rows are dropped
        pad = chunk - L % chunk
        xh, dt, Bc, Cc = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) for t in (xh, dt, Bc, Cc))
        L += pad
    nc = L // chunk
    dt = dt.float().reshape(Bsz, nc, chunk, H)
    cum = torch.cumsum(dt * A, dim=2)  # (B, nc, cs, H) within-chunk log-decay

    def heads_first(t):  # (B, L, X, K) → (B, X, nc, cs, K), a view where it can be
        return t.reshape(Bsz, nc, chunk, t.shape[2], t.shape[3]).permute(0, 3, 1, 2, 4)

    y_intra, states = intra(
        heads_first(xh), dt.permute(0, 3, 1, 2), cum.permute(0, 3, 1, 2),
        heads_first(Bc), heads_first(Cc),
    )  # (B, H, nc, cs, P), (B, H, nc, N, P)

    # inter-chunk recurrence (repro's lax.scan): S_c = exp(cum_end_c)·S_{c-1} + state_c
    chunk_decay = torch.exp(cum[:, :, -1])  # (B, nc, H)
    s = (
        initial_state.float() if initial_state is not None
        else torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=xh.device)
    )
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, :, c]
    s_prev = torch.stack(s_prevs, dim=1).reshape(Bsz, nc, G, H // G, N, P)

    # inter-chunk contribution: C_i · S_prev, decayed by exp(cum_i)
    Cg = Cc.reshape(Bsz, nc, chunk, G, N).float()
    y_inter = torch.einsum("bcign,bcgknp->bcigkp", Cg, s_prev).reshape(Bsz, nc, chunk, H, P)
    y = y_intra.permute(0, 2, 3, 1, 4) + y_inter * torch.exp(cum)[..., None]
    return y.reshape(Bsz, L, H, P)[:, :L0], s


def ssd_chunked(xh, dt, A, Bc, Cc, chunk: int, initial_state=None):
    """Chunked SSD scan with the contract of ``repro.models.ssm.ssd_chunked``:
    xh (B, L, H, P), dt (B, L, H) [post-softplus], A (H,) [negative], Bc/Cc
    (B, L, H, N), or (B, L, G, N) with G | H groups read in place.
    → (y (B, L, H, P) float32, final_state (B, H, N, P) float32).

    Any L: a ragged tail is padded as ``repro`` pads.  The intra-chunk part
    goes through :func:`ssd_intra_chunk`; the within-chunk cumsum, the
    inter-chunk recurrence and the inter-chunk output stay plain torch, as
    they are jnp in ``repro``."""
    return _chunked(xh, dt, A, Bc, Cc, chunk, initial_state, ssd_intra_chunk)


def ssd_chunked_ref(xh, dt, A, Bc, Cc, chunk: int, initial_state=None):
    """:func:`ssd_chunked` with the plain intra-chunk version on any device:
    the codelet's host implementation, and the yardstick of the kernel's
    scan on the card."""
    return _chunked(xh, dt, A, Bc, Cc, chunk, initial_state, ssd_chunk_ref)


# -- codelet registration (SpCpu/SpCuda selection, paper §4.3) ---------------

@sp_task(read=("xh", "dt", "A", "Bc", "Cc"), write=("out",), name="ssd_chunked")
def ssd_codelet(xh, dt, A, Bc, Cc, out, *, chunk: int, initial_state=None):
    out.value = ssd_chunked_ref(xh, dt, A, Bc, Cc, chunk, initial_state)


@ssd_codelet.impl("cuda", available=dispatch.cuda_available)
def _ssd_cuda_impl(xh, dt, A, Bc, Cc, out, *, chunk: int, initial_state=None):
    out.value = ssd_chunked(xh, dt, A, Bc, Cc, chunk, initial_state)
