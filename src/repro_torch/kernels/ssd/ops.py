"""Wrappers for the SSD intra-chunk kernels (``csrc/ssd.cu``,
``csrc/ssd_wide.cu``) and their backward (``csrc/ssd_bwd_wgmma.cu``,
``csrc/ssd_wide.cu``), the autograd function over them, and the chunked SSD
scan built on it.

Replaces ``src/repro/kernels/ssd/kernel.py::ssd_intra_chunk_pallas`` and the
scan around it, ``ops.py::ssd_chunked_pallas``.  Two routes, chosen by
:func:`route` before any launch, each counted apart:

- the *main* route, bfloat16 at a chunk of at most 256, P <= 64 and N <=
  128 in 16-byte chunks (the serving and train paths): the three products
  on the tensor cores (``wgmma``), two blocks per chunk, each holding the
  chunk's B and x and two causal 64-row tiles of C in shared memory, with
  the f32 decay weights carried as a bf16 hi + lo pair so the f32 accuracy
  is kept (:data:`launches`, :data:`bwd_launches`);
- the *wide* route, every other shape: every float32 shape, and bfloat16
  with a chunk above 256, P above 64, N above 128, P or N not a multiple
  of 8, or a base or stride off the 16-byte grid (``csrc/ssd_wide.cu``):
  SIMT, float32 accumulation, 64 × 64 output tiles over any P, N and chunk
  (:data:`wide_launches`, :data:`wide_bwd_launches`; launch plans
  :func:`wide_fwd_plan`, :func:`wide_bwd_plan`).

Both never compute the masked triangle, whose decay may be inf, and read the
model's (B, L, H, ·) layout, and B/C by group, through strides, so nothing
is transposed or expanded.  A CPU tensor takes the plain version in
``ref.py``; a CUDA tensor launches a kernel or raises; ``meta`` tensors take
the meta route (``dispatch``): the outputs alone, and :func:`fwd_flops` /
:func:`bwd_flops`.

The backward has no Pallas counterpart: ``repro`` trains mamba2 through
``jax.grad`` of the jnp ``ssd_chunked``.  :func:`ssd_intra_chunk_bwd` runs
its vector-Jacobian product on the same two routes, both summing dB / dC
over each group's heads in a fixed order (no atomics): the main route on
the tensor cores (``csrc/ssd_bwd_wgmma.cu``: two warpgroups a block in a
column role (dx, dB, ddt, dcum) or a row role (dC), walking its group's
heads in order with dB / dC in f32 registers; the plan is
:func:`bwd_tc_launch_plan`), the wide route on the SIMT cores.  On CUDA
(and meta) tensors :func:`ssd_intra_chunk` always goes through
:class:`SsdIntraChunkFn`, whose backward launches those kernels; under
``torch.no_grad`` (serving) it records nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.api import sp_task
from repro_torch.kernels import dispatch

from .ref import ssd_chunk_bwd_ref, ssd_chunk_ref

#: launches of the main (tensor-core) route through :func:`ssd_intra_chunk`
#: (``.count``)
launches = dispatch.LaunchCounter()
#: launches of the main route's backward through :func:`ssd_intra_chunk_bwd`
bwd_launches = dispatch.LaunchCounter()
#: launches of the wide route's forward (``csrc/ssd_wide.cu``)
wide_launches = dispatch.LaunchCounter()
#: launches of the wide route's backward
wide_bwd_launches = dispatch.LaunchCounter()

#: the widest head and state dims of the main route (``ssd.cu`` /
#: ``ssd_bwd_wgmma.cu``); wider ones take the wide route
MAIN_MAX_HEAD_DIM = 64
MAIN_MAX_STATE_DIM = 128
#: rows of a tile (i and j) and the longest chunk of the tensor-core route
TILE = 64
TC_MAX_CHUNK = 256


class TcBlock(NamedTuple):
    """The work of one block of the tensor-core route for one chunk."""
    half: int                               # blockIdx.x
    y_tiles: tuple[tuple[int, tuple[int, ...]], ...]  # (i tile, its j tiles)
    state_rows: tuple[int, int]             # [lo, hi) of the N state rows
    state_j_tiles: tuple[int, ...]


def tc_launch_plan(cs: int, N: int = MAIN_MAX_STATE_DIM) -> list[TcBlock]:
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


class BwdTcBlock(NamedTuple):
    """One block of the bfloat16 backward kernel for one chunk."""
    y: int                       # blockIdx.y: the role and tile, the heaviest first
    group: int
    role: str                    # "column" (dx, dB, ddt, dcum) or "row" (dC)
    tile: int                    # the j tile (column) or the i tile (row) it owns
    partners: tuple[int, ...]    # the i tiles (column) or j tiles (row) it walks, in order
    heads: tuple[int, ...]       # its group's heads, in the order it walks them
    warpgroups: tuple[tuple[int, ...], tuple[int, ...]]  # the partners each warpgroup takes


def bwd_tc_launch_plan(cs: int, heads: int, groups: int) -> list[BwdTcBlock]:
    """The blocks ``ssd_bwd_wgmma_kernel`` runs for one chunk, in launch
    order, as the kernel indexes them: its grid is (batch · groups ·
    chunks, 2 · tiles) and blocks launch with blockIdx.x fastest, so every
    chunk's blocks of one ``y`` go before the next ``y``.  ``y < tiles`` is
    the column role of j tile ``y`` (i tiles ``y`` to the last), the rest
    the row role of i tile ``2·tiles − 1 − y`` (j tiles 0 to it): the
    heaviest blocks first.  Each walks all of its group's heads in order,
    so dB and dC sum them in head order inside the block; its two
    warpgroups share each head, warpgroup w taking every other partner
    tile from the w-th."""
    n_tiles = -(-cs // TILE)
    per = heads // groups
    plan = []
    for y in range(2 * n_tiles):
        for g in range(groups):
            hs = tuple(range(g * per, (g + 1) * per))
            if y < n_tiles:
                role, tile, partners = "column", y, tuple(range(y, n_tiles))
            else:
                role, tile = "row", 2 * n_tiles - 1 - y
                partners = tuple(range(tile + 1))
            plan.append(BwdTcBlock(y, g, role, tile, partners, hs, (partners[0::2], partners[1::2])))
    return plan


class WideBlock(NamedTuple):
    """One block of the wide route for one (sequence, head or group, chunk):
    it owns rows [row0, row0 + rows) × columns [col0, col0 + cols) of one
    output."""
    output: str
    row0: int
    rows: int
    col0: int
    cols: int


def _tiles(n: int) -> list[tuple[int, int]]:
    return [(t0, min(TILE, n - t0)) for t0 in range(0, n, TILE)]


def wide_fwd_plan(cs: int, P: int, N: int) -> list[WideBlock]:
    """The blocks ``ssd_wide_fwd_kernel`` runs for one chunk of one head,
    in blockIdx.x order: the y role over (i tile, P tile), then the state
    role over (N tile, P tile)."""
    return ([WideBlock("y", i0, ni, p0, np_) for i0, ni in _tiles(cs) for p0, np_ in _tiles(P)]
            + [WideBlock("state", n0, nn, p0, np_) for n0, nn in _tiles(N) for p0, np_ in _tiles(P)])


def wide_bwd_plan(cs: int, P: int, N: int) -> list[WideBlock]:
    """The blocks of the wide backward's three kernels for one chunk: dx by
    (j tile, P tile) a head; dB by (j tile, N tile) and dC by (i tile, N
    tile) a group, each walking the group's heads in order; ddt and dcum by
    one block over every row (the last row's sum included)."""
    return ([WideBlock("dx", j0, nj, p0, np_) for j0, nj in _tiles(cs) for p0, np_ in _tiles(P)]
            + [WideBlock("dB", j0, nj, n0, nn) for j0, nj in _tiles(cs) for n0, nn in _tiles(N)]
            + [WideBlock("dC", i0, ni, n0, nn) for i0, ni in _tiles(cs) for n0, nn in _tiles(N)]
            + [WideBlock("ddt", 0, cs, 0, 1), WideBlock("dcum", 0, cs, 0, 1)])


def route(cs: int, P: int, N: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """The route a call (either way) takes, by shape, before any launch:
    ``"main"`` (``ssd.cu`` / ``ssd_bwd_wgmma.cu``: bfloat16 with cs <= 256,
    P <= 64, N <= 128 and the 16-byte layout, ``aligned``) or ``"wide"``
    (``ssd_wide.cu``: every other shape, float32 included)."""
    if dtype != torch.bfloat16 or not aligned:
        return "wide"
    return "main" if cs <= TC_MAX_CHUNK and P <= MAIN_MAX_HEAD_DIM and N <= MAIN_MAX_STATE_DIM else "wide"


def meets_tensor_core_layout(**tensors: torch.Tensor) -> bool:
    """Whether the main route's 16-byte copies can read every tensor: its
    base on 16 bytes, its last dim (P or N) a multiple of 8 elements and
    every stride of a dim with more than one index a whole multiple of 8
    elements."""
    return not any(t.data_ptr() % 16 or t.shape[-1] % 8
                   or any(t.shape[d] > 1 and t.stride(d) % 8 for d in range(t.ndim - 1))
                   for t in tensors.values())


def fwd_flops(b: int, H: int, nc: int, cs: int, P: int, N: int) -> int:
    """The forward's operations: per (sequence, head, chunk) the scores C·Bᵀ
    (N) and y (P) over the causal pairs, and the state (N × P) over every
    row."""
    pairs = cs * (cs + 1) // 2
    return b * H * nc * (2 * pairs * (N + P) + 2 * cs * N * P)


def bwd_flops(b: int, H: int, nc: int, cs: int, P: int, N: int) -> int:
    """The backward's operations: per (sequence, head, chunk) s (N), dW (P),
    dx (P), dC (N) and dB (N) over the causal pairs, and u = dS·x, v =
    dSᵀ·B over every row."""
    pairs = cs * (cs + 1) // 2
    return b * H * nc * (2 * pairs * (3 * N + 2 * P) + 4 * cs * N * P)


def _check(name: str, x, dt, cum, B, C) -> tuple:
    """Shapes, dtypes and layouts every route takes; → (b, H, nc, cs, P, G,
    N, dtype code, meta route, wide route)."""
    meta = dispatch.check_kernel_tensors(name, x, dt, cum, B, C)
    if x.ndim != 5:
        raise ValueError(f"{name}: x must be (b, H, nc, cs, P), got {tuple(x.shape)}")
    Bsz, H, nc, cs, P = x.shape
    G, N = B.shape[1], B.shape[-1]
    if (
        tuple(B.shape) != (Bsz, G, nc, cs, N) or C.shape != B.shape
        or tuple(dt.shape) != (Bsz, H, nc, cs) or cum.shape != dt.shape
        or G < 1 or H % G
    ):
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, cum "
            f"{tuple(cum.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)} do not fit "
            "(b, H, nc, cs, ·) with B/C on H or on G | H groups"
        )
    if not (x.dtype == B.dtype == C.dtype):
        raise TypeError(f"{name}: mixed dtypes x {x.dtype}, B {B.dtype}, C {C.dtype}")
    if dt.dtype != torch.float32 or cum.dtype != torch.float32:
        raise TypeError(f"{name}: dt and cum must be float32, got {dt.dtype}, {cum.dtype}")
    if any(t.shape[-1] > 1 and t.stride(-1) != 1 for t in (x, B, C)):
        raise ValueError(f"{name}: the last dim of x, B and C must be contiguous")
    aligned = x.dtype == torch.bfloat16 and meets_tensor_core_layout(x=x, B=B, C=C)
    wide = route(cs, P, N, x.dtype, aligned) == "wide"
    return Bsz, H, nc, cs, P, G, N, dispatch.dtype_code(name, x), meta, wide


def _intra_chunk_kernel(x, dt, cum, B, C):
    """The forward launch: → (y, state) written by ``csrc/ssd.cu`` or
    ``csrc/ssd_wide.cu``."""
    Bsz, H, nc, cs, P, G, N, code, meta, wide = _check("ssd_intra_chunk", x, dt, cum, B, C)
    # y in the model's (b, nc, cs, H, P) order, seen as (b, H, nc, cs, P)
    y = torch.empty((Bsz, nc, cs, H, P), dtype=torch.float32, device=x.device).permute(0, 3, 1, 2, 4)
    state = torch.empty((Bsz, H, nc, N, P), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, state.zero_()
    if meta:
        dispatch.meta_launch("ssd_intra_chunk", (Bsz, H, nc, cs, P, G, N), fwd_flops(Bsz, H, nc, cs, P, N))
        return y, state
    lib = dispatch.library()
    dims = (0, 1, 2, 3)
    rc = (lib.ssd_intra_chunk_wide_fwd if wide else lib.ssd_intra_chunk_fwd)(
        x.data_ptr(), dt.data_ptr(), cum.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), state.data_ptr(), Bsz, H, H // G, nc, cs, P, N,
        dispatch.strides(x, dims), dispatch.strides(dt, dims), dispatch.strides(cum, dims),
        dispatch.strides(B, dims), dispatch.strides(C, dims), dispatch.strides(y, dims),
        dispatch.strides(state, (0, 1, 2)), code, dispatch.stream_handle(x),
    )
    dispatch.check(rc, "ssd_intra_chunk")
    (wide_launches if wide else launches).add((Bsz, H, nc, cs, P, G, N))
    return y, state


class SsdIntraChunkFn(torch.autograd.Function):
    """Differentiable intra-chunk step on the card: the forward kernel, and
    the backward kernel on the saved inputs (nothing else is saved)."""

    @staticmethod
    def forward(ctx, x, dt, cum, B, C):
        ctx.save_for_backward(x, dt, cum, B, C)
        return _intra_chunk_kernel(x, dt, cum, B, C)

    @staticmethod
    def backward(ctx, dy, dS):
        return ssd_intra_chunk_bwd(*ctx.saved_tensors, dy, dS)


def ssd_intra_chunk(x, dt, cum, B, C):
    """The intra-chunk output and the end-of-chunk state of every chunk.

    x (b, H, nc, cs, P); dt, cum (b, H, nc, cs) float32; B, C
    (b, G, nc, cs, N), G | H groups (G = H: one per head; head h reads
    group h // (H // G)).  Any strides with a contiguous last dim.
    → (y (b, H, nc, cs, P), state (b, H, nc, N, P)), both float32.  (The
    plain version also takes the TPU kernel's (BH, nc, cs, ·) layout.)
    Differentiable on both routes: CUDA tensors go through
    :class:`SsdIntraChunkFn`.
    """
    if all(t.device.type == "cpu" for t in (x, dt, cum, B, C)):
        return ssd_chunk_ref(x, dt, cum, B, C)
    return SsdIntraChunkFn.apply(x, dt, cum, B, C)


def ssd_intra_chunk_bwd(x, dt, cum, B, C, dy, dS):
    """The vector-Jacobian product of :func:`ssd_intra_chunk` for the
    cotangents ``dy`` (b, H, nc, cs, P) of y and ``dS`` (b, H, nc, N, P)
    of the state, both float32 → (dx, ddt, dcum, dB, dC) with the inputs'
    shapes and dtypes, in the model's (b, nc, cs, ·, ·) memory order; dB
    and dC sum each group's heads.  Accumulated in float32 without atomics
    (the same bits on every run).  ``dy`` is read through its strides (a
    non-contiguous last dim is copied once); ``dS`` is copied once unless
    each (N, P) matrix is contiguous.  The main route runs on the tensor
    cores (its first pass converts dy and dS to bfloat16 copies); every
    other shape, float32 included, takes the wide route (:func:`route`)."""
    if all(t.device.type == "cpu" for t in (x, dt, cum, B, C, dy, dS)):
        return ssd_chunk_bwd_ref(x, dt, cum, B, C, dy, dS)
    name = "ssd_intra_chunk_bwd"
    Bsz, H, nc, cs, P, G, N, code, meta, wide = _check(name, x, dt, cum, B, C)
    dispatch.check_kernel_tensors(name, x, dy, dS)
    if (
        tuple(dy.shape) != (Bsz, H, nc, cs, P) or tuple(dS.shape) != (Bsz, H, nc, N, P)
        or dy.dtype != torch.float32 or dS.dtype != torch.float32
    ):
        raise ValueError(
            f"{name}: dy {tuple(dy.shape)} {dy.dtype} and dS {tuple(dS.shape)} {dS.dtype} are not "
            f"float32 {(Bsz, H, nc, cs, P)} and {(Bsz, H, nc, N, P)}"
        )
    if P > 1 and dy.stride(-1) != 1:
        dy = dy.contiguous()
    if (P > 1 and dS.stride(-1) != 1) or (N > 1 and dS.stride(-2) != P):
        dS = dS.contiguous()
    dev = x.device

    def heads_last(shape, dtype):  # allocated (b, nc, cs, X[, K]), seen as (b, X, nc, cs[, K])
        t = torch.empty((Bsz, nc, cs) + shape, dtype=dtype, device=dev)
        return t.permute(0, 3, 1, 2, 4) if len(shape) == 2 else t.permute(0, 3, 1, 2)

    dx = heads_last((H, P), x.dtype)
    ddt, dcum = heads_last((H,), torch.float32), heads_last((H,), torch.float32)
    dB, dC = heads_last((G, N), B.dtype), heads_last((G, N), C.dtype)
    if dx.numel() == 0:
        return tuple(t.zero_() for t in (dx, ddt, dcum, dB, dC))
    if meta:
        dispatch.meta_launch(name, (Bsz, H, nc, cs, P, G, N), bwd_flops(Bsz, H, nc, cs, P, N))
        return dx, ddt, dcum, dB, dC
    lib = dispatch.library()
    dims = (0, 1, 2, 3)
    if wide:
        rc = lib.ssd_intra_chunk_wide_bwd(
            *(t.data_ptr() for t in (x, dt, cum, B, C, dy, dS, dx, ddt, dcum, dB, dC)),
            Bsz, H, H // G, nc, cs, P, N,
            *(dispatch.strides(t, dims) for t in (x, dt, cum, B, C, dy)), dispatch.strides(dS, (0, 1, 2)),
            *(dispatch.strides(t, dims) for t in (dx, ddt, dcum, dB, dC)), code, dispatch.stream_handle(x),
        )
        dispatch.check(rc, name)
        wide_bwd_launches.add((Bsz, H, nc, cs, P, G, N))
        return dx, ddt, dcum, dB, dC
    tiles = -(-cs // TILE)
    f32 = dict(dtype=torch.float32, device=dev)
    # bf16 copies of dy and dS; rowsum(M) and the last row's sum in parts by (j tile, warp)
    scratch = (torch.empty((Bsz, H, nc, cs, P), dtype=torch.bfloat16, device=dev),
               torch.empty((Bsz, H, nc, N, P), dtype=torch.bfloat16, device=dev),
               torch.empty((Bsz, H, nc, tiles, 4, cs), **f32), torch.empty((Bsz, H, nc, tiles, 4), **f32))
    rc = lib.ssd_intra_chunk_bwd_tc(
        *(t.data_ptr() for t in (x, dt, cum, B, C, dy, dS, dx, ddt, dcum, dB, dC, *scratch)),
        Bsz, H, H // G, nc, cs, P, N,
        *(dispatch.strides(t, dims) for t in (x, dt, cum, B, C, dy)), dispatch.strides(dS, (0, 1, 2)),
        *(dispatch.strides(t, dims) for t in (dx, ddt, dcum, dB, dC)), dispatch.stream_handle(x),
    )
    dispatch.check(rc, name)
    bwd_launches.add((Bsz, H, nc, cs, P, G, N))
    return dx, ddt, dcum, dB, dC


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
