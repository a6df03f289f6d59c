"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. header   — card name and power limit (nvidia-smi), torch and CUDA versions;
2. build    — builds the hand-written kernels from ``src/repro_torch/kernels/csrc``;
3. kernels  — the HGMMA count of the flash and ssd kernels' SASS where
              ``cuobjdump`` is present (the bf16 routes have some, the f32
              routes none); each kernel against its plain PyTorch version on
              the card, at the serving paths' shapes (deepseek-7b,
              mamba2-130m; bf16) and at edge shapes (fp32 and bf16), with
              kernel / plain / library times and bounds (rmsnorm also at both
              paths' decode rows, decode also at short positions; decode is
              checked run to run identical and batch-invariant, the ssd bound
              is logged in both reckonings); then one codelet per kernel on a
              device worker;
4. serving  — full-width deepseek-7b (30 layers, bf16, seeded random init)
              through ``repro_torch.serving.ServeEngine``: ragged prompts and a
              sampled request, then duplicates that take the prefix-share and
              the restore paths; launch counts show the path ran through all
              three of its kernels; one greedy request is held against a
              sequential prefill + decode loop; a decode iteration and the
              2048-token prefill alone are profiled;
5. serving  — full-width mamba2-130m (24 layers, bf16, seeded random init):
              prompts up to 4096 tokens, a sampled request and a duplicate
              (re-prefilled: ssm states are not paged); launch counts show the
              path ran through the ssd and rmsnorm kernels; a request admitted
              beside 7 decoding ones is held against prefill (its installed
              caches) and against the sequential loop (tokens, last logits
              and caches);
6. model    — full width cut in depth, fp32: the card's logits against the
              CPU port's (plain versions) for a prompt and decode steps, for
              deepseek-7b (2 layers) and mamba2-130m (4 layers).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Needs one card; imports nothing of JAX.
"""
from __future__ import annotations

import gc
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

# peak rates of one H100 SXM (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}

# the serving phase's requests (prompt lengths) and decode length
PROMPT_LENS = (2048, 777, 100)
SAMPLED_LEN = 321  # 20 blocks + 1: its duplicate restores prompt[:-1] from full blocks
GEN = 16
N_SLOTS = 4
MAX_SEQ = 2304
BLOCK_SIZE = 16
# the mamba2-130m serving phase: 4096 = 16 chunks of 256, 777 a ragged tail,
# 100 a single short chunk; the sampled prompt has 1000 tokens
M_PROMPT_LENS = (4096, 2048, 777, 100)
M_SAMPLED_LEN = 1000
M_GEN = 32
M_SLOTS = 8
M_MAX_SEQ = 4352
M_WARM_EXTRA = (256, 512, 64)  # the warm-up wave's last 3 prompts: all 8 slots busy


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 1. header
# ---------------------------------------------------------------------------

def header() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def build_kernels() -> float:
    from repro_torch.kernels import dispatch

    t0 = time.perf_counter()
    dispatch.library()
    dt = time.perf_counter() - t0
    log(f"[build] kernels built and loaded in {dt:.2f} s")
    for line in dispatch.build_log().splitlines():
        # "Potential Performance Loss": ptxas serialised a kernel's wgmmas
        if "registers" in line or "bytes stack" in line or "Performance Loss" in line or line.startswith("=="):
            log(f"[build] {line.strip()}")
    return dt


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def _randn(gen, shape, dtype, dev, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def _compare(name, got, want, dtype, tol=None) -> float:
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output not finite")
    err = (got - want).abs()
    tol = tol or TOL[dtype]
    bad = err > tol["atol"] + tol["rtol"] * want.abs()
    max_err = float(err.max())
    log(f"[kernels] {name}: max_abs_err {max_err:.3e} (limit atol {tol['atol']:.3g} + rtol {tol['rtol']}·|plain|)")
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside tolerance")
    return max_err


def time_ms(fn, arg_sets, iters: int = 20) -> float:
    """Device time of one call: ``iters`` calls captured into a CUDA graph
    (no host launch gaps), cycling through ``arg_sets`` so repeated calls do
    not all hit the 50 MB L2 cache, replayed between two CUDA events."""
    for args in arg_sets:  # warm up (and set kernel attributes) outside capture
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(bytes_moved: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_rmsnorm(dev) -> dict:
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    err = 0.0
    # each serving path's rows: deepseek-7b D = 4096 (decode T = 1, prefill),
    # mamba2-130m D = 768 (decode T = 1 and 8, prefill up to 4096); then edges:
    # qk-norm rows (128), tiny rows, a D that is not a multiple of the vector
    # (37: the scalar path), one beyond the register path (12288: looped)
    cases = ((1, 4096), (100, 4096), (2048, 4096), (1, 768), (8, 768), (100, 768), (4096, 768),
             (37, 128), (5, 16), (3, 37), (7, 12288))
    for dtype in (torch.bfloat16, torch.float32):
        for T, D in cases:
            x = _randn(gen, (T, D), dtype, dev)
            s = _randn(gen, (D,), dtype, dev, 0.1)
            e = _compare(f"rmsnorm {dtype} T={T} D={D}", ops.rmsnorm(x, s), rmsnorm_ref(x, s), dtype)
            if dtype == torch.bfloat16 and (T, D) == (2048, 4096):
                err = e
        # rows one element into a buffer: no 16-byte alignment, scalar path
        T, D = 50, 768
        x = _randn(gen, (T * D + 1,), dtype, dev)[1:].view(T, D)
        s = _randn(gen, (D,), dtype, dev, 0.1)
        _compare(f"rmsnorm {dtype} T={T} D={D} unaligned rows", ops.rmsnorm(x, s), rmsnorm_ref(x, s), dtype)
    # the paths' shapes: deepseek-7b prefill rows (the record's), then the
    # decode rows of deepseek-7b (4 slots) and mamba2-130m (8 slots)
    dtype = torch.bfloat16
    times = {}
    for T, D in ((2048, 4096), (4, 4096), (8, 768)):
        sets = [(_randn(gen, (T, D), dtype, dev), _randn(gen, (D,), dtype, dev, 0.1)) for _ in range(4)]
        weights = [(x, (1.0 + s.float()).to(dtype)) for x, s in sets]
        bound, by = _bound(2 * T * D * 2 + D * 2, 4 * T * D, dtype)
        times[(T, D)] = dict(
            ms=time_ms(ops.rmsnorm, sets), plain_ms=time_ms(rmsnorm_ref, sets),
            library_ms=time_ms(lambda x, w: torch.nn.functional.rms_norm(x, (w.shape[0],), w, 1e-6), weights),
            bound_ms=bound, bound_by=by,
        )
        t = times[(T, D)]
        log(f"[kernels] rmsnorm x ({T}, {D}) bf16: kernel {t['ms']:.4f} ms, F.rms_norm {t['library_ms']:.4f} ms "
            f"(kernel / library {t['ms'] / t['library_ms']:.2f}), plain {t['plain_ms']:.4f} ms, bound "
            f"{bound:.4f} ms ({by}, {bound / t['ms']:.1%} of it)")
    T, D = 2048, 4096
    return dict(
        name="rmsnorm", route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm/kernel.py:27", max_abs_err=err, **times[(T, D)],
        shape=f"x ({T}, {D}) bf16",
    )


def _pairs(Lq, Lk, causal, window, q_offset) -> int:
    """(query, key) pairs the mask keeps: the work this input needs."""
    qpos = torch.arange(Lq, dtype=torch.int64) + q_offset
    hi = torch.clamp(qpos + 1, max=Lk) if causal else torch.full_like(qpos, Lk)
    lo = torch.clamp(qpos - window + 1, min=0) if window else torch.zeros_like(qpos)
    return int(torch.clamp(hi - lo, min=0).sum())


def _hgmma_counts() -> dict | None:
    """HGMMA (wgmma) instructions in the SASS of each flash-attention and
    ssd kernel of the built library, by ``cuobjdump -sass``; None where the
    tool is missing."""
    from repro_torch.kernels import dispatch

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(dispatch.build())], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(flash_fwd_\w*?kernel|ssd_chunk_\w*?kernel)(?:I(\w*?)E+v)?", line)
            fn = (f"{m.group(1)}<{m.group(2)}>" if m.group(2) else m.group(1)) if m else None
            if fn:
                counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    return counts


def check_hgmma() -> dict | None:
    """The bf16 routes of flash and ssd run on the tensor cores (HGMMA in
    their SASS); the f32 routes do not."""
    counts = _hgmma_counts()
    if counts is None:
        log("[kernels] cuobjdump not on this machine: HGMMA counts not taken")
        return None
    log("[kernels] HGMMA instructions in the SASS: "
        + ", ".join(f"{k}: {v}" for k, v in counts.items()))
    tc = [k for k in counts if "wgmma" in k]
    simt = [k for k in counts if "wgmma" not in k]
    assert any(k.startswith("ssd_chunk_wgmma") for k in tc) and any(k.startswith("flash") for k in tc), counts
    assert all(counts[k] > 0 for k in tc) and all(counts[k] == 0 for k in simt), counts
    return counts


def check_flash(dev) -> dict:
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device=dev).manual_seed(2)
    # every case in bf16 (tensor cores) and fp32 (SIMT)
    cases = [  # (B, Lq, Lk, H, KH, Dh, Dv, causal, window, q_offset)
        (1, 2048, 2048, 32, 32, 128, 128, True, None, 0),
        (2, 1000, 1000, 32, 8, 128, 128, True, 256, 0),
        (1, 300, 1000, 8, 2, 64, 64, True, None, 700),
        (1, 333, 333, 4, 4, 128, 128, False, None, 0),
        (2, 77, 77, 4, 1, 32, 32, True, 40, 0),
        (1, 1, 777, 8, 8, 128, 128, True, None, 776),  # one query row
        (1, 500, 500, 16, 16, 80, 80, True, None, 0),  # head dim padded to 128
    ]
    err = 0.0
    for B, Lq, Lk, H, KH, Dh, Dv, causal, window, q_off in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q = _randn(gen, (B, Lq, H, Dh), dtype, dev)
            k = _randn(gen, (B, Lk, KH, Dh), dtype, dev)
            v = _randn(gen, (B, Lk, KH, Dv), dtype, dev)
            kw = dict(causal=causal, window=window, q_offset=q_off)
            e = _compare(
                f"flash {dtype} B={B} Lq={Lq} Lk={Lk} H={H} KH={KH} Dh={Dh} Dv={Dv} {kw}",
                ops.flash_attention(q, k, v, **kw), attention_ref(q, k, v, **kw), dtype,
            )
            if Lq == 2048 and dtype == torch.bfloat16:
                err = e
    B, L, H, D, dtype = 1, 2048, 32, 128, torch.bfloat16
    sets = [tuple(_randn(gen, (B, L, H, D), dtype, dev) for _ in range(3)) for _ in range(2)]
    ms = time_ms(lambda q, k, v: ops.flash_attention(q, k, v, causal=True), sets)
    plain = time_ms(lambda q, k, v: attention_ref(q, k, v, causal=True), sets)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = time_ms(
        lambda q, k, v: sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True),
        sets,
    )
    flops = 4 * B * H * D * _pairs(L, L, True, None, 0)
    bound, by = _bound(4 * B * L * H * D * 2, flops, dtype)
    log(f"[kernels] flash at ({B}, {L}, {H}, {D}) bf16 causal: {flops / 1e9:.2f} GFLOP, kernel "
        f"{flops / ms / 1e9:.1f} TFLOP/s, kernel / SDPA {ms / lib:.2f}")
    return dict(
        name="flash_attention", route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:111", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib,
        shape=f"q/k/v ({B}, {L}, {H}, {D}) bf16 causal",
    )


def check_decode(dev) -> dict:
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    gen = torch.Generator(device=dev).manual_seed(3)
    main_pos = [p + GEN - 1 for p in PROMPT_LENS] + [SAMPLED_LEN + GEN - 1]
    cases = [  # (B, S, H, KH, D, pos, dtypes)
        (N_SLOTS, MAX_SEQ, 32, 32, 128, main_pos, (torch.bfloat16,)),
        (4, 1000, 32, 8, 128, [0, 999, 500, 63], (torch.bfloat16, torch.float32)),
        (4, 256, 8, 2, 64, [1000, 10, 255, 256], (torch.bfloat16, torch.float32)),  # ring
        (3, 70, 4, 4, 16, [69, 0, 64], (torch.float32,)),
        (3, 300, 6, 2, 12, [299, 0, 130], (torch.bfloat16, torch.float32)),  # 24-byte bf16 rows
    ]
    err = 0.0
    for B, S, H, KH, D, pos_l, dtypes in cases:
        for dtype in dtypes:
            q = _randn(gen, (B, 1, H, D), dtype, dev)
            k = _randn(gen, (B, S, KH, D), dtype, dev)
            v = _randn(gen, (B, S, KH, D), dtype, dev)
            pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
            e = _compare(
                f"decode {dtype} B={B} S={S} H={H} KH={KH} D={D} pos={pos_l}",
                ops.decode_attention(q, k, v, pos), decode_attention_ref(q, k, v, pos), dtype,
            )
            if S == MAX_SEQ:
                err = e
    # run to run identical, and batch-invariant: each sequence beside empty
    # slots (positions 0) equals itself beside the live ones, bit for bit
    B, S, H, D, dtype = N_SLOTS, MAX_SEQ, 32, 128, torch.bfloat16
    for KH in (32, 8):
        q = _randn(gen, (B, 1, H, D), dtype, dev)
        k, v = (_randn(gen, (B, S, KH, D), dtype, dev) for _ in range(2))
        live = torch.tensor(main_pos, dtype=torch.int32, device=dev)
        first = ops.decode_attention(q, k, v, live)
        assert all(torch.equal(ops.decode_attention(q, k, v, live), first) for _ in range(3)), "not deterministic"
        for b in range(B):
            alone = torch.zeros_like(live)
            alone[b] = live[b]
            assert torch.equal(ops.decode_attention(q, k, v, alone)[b], first[b]), f"batch-variant at b={b}"
        log(f"[kernels] decode KH={KH}: run to run identical and batch-invariant at pos {main_pos}")
    # times at the path's positions and at short ones, same cache
    short_pos = [15, 100, 31, 64]
    cache_sets = [
        (_randn(gen, (B, 1, H, D), dtype, dev), _randn(gen, (B, S, H, D), dtype, dev),
         _randn(gen, (B, S, H, D), dtype, dev))
        for _ in range(2)
    ]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec = {}
    for label, pos_l in (("main", main_pos), ("short", short_pos)):
        pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
        sets = [(q, k, v, pos) for q, k, v in cache_sets]
        ms = time_ms(ops.decode_attention, sets)
        plain = time_ms(decode_attention_ref, sets)
        valid = (torch.arange(S, device=dev)[None, :] <= pos[:, None])[:, None, None, :]
        lib = time_ms(
            lambda q, k, v, p: sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=valid),
            sets,
        )
        n_valid = sum(min(p + 1, S) for p in pos_l)
        bytes_moved = (2 * B * H * D + 2 * n_valid * H * D) * 2 + B * 4
        bound, by = _bound(bytes_moved, 4 * n_valid * H * D, dtype)
        rec[label] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by)
        log(f"[kernels] decode at pos {pos_l} (cache ({B}, {S}, {H}, {D}) bf16): kernel {ms:.4f} ms, SDPA "
            f"{lib:.4f} ms, plain {plain:.4f} ms, bound {bound:.5f} ms ({by}, {bound / ms:.1%} of it)")
    return dict(
        name="decode_attention", route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:81", max_abs_err=err, **rec["main"],
        short=rec["short"], shape=f"q ({B}, 1, {H}, {D}), cache ({B}, {S}, {H}, {D}) bf16, pos {main_pos}",
    )


# ssd outputs are float32 sums of up to cs·N products, whatever the input
# type (both sides read the same bf16 values exactly), so their rounding error
# scales with the output's magnitude, not each element's: the limit is
# SSD_ATOL·max|plain| + SSD_RTOL·|plain|.  A wrong kernel is off by O(max).
SSD_ATOL, SSD_RTOL = 5e-5, 1e-4


def _compare_ssd(name, got, want) -> float:
    scale = float(want.float().abs().max())
    tol = dict(atol=SSD_ATOL * scale, rtol=SSD_RTOL)
    return _compare(f"{name} (max|plain| {scale:.3e})", got, want, None, tol)


def _ssd_inputs(gen, dev, dtype, L, H, P, N, G, dt_shift=-1.0):
    """Model-layout inputs of ``ssd_chunked``: x (1, L, H, P), B/C (1, L, G,
    N) in ``dtype``; dt = softplus(randn + dt_shift) and A < 0 in float32."""
    x = _randn(gen, (1, L, H, P), dtype, dev)
    Bm, Cm = (_randn(gen, (1, L, G, N), dtype, dev) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn((1, L, H), generator=gen, device=dev) + dt_shift)
    A = -torch.exp(torch.randn((H,), generator=gen, device=dev) * 0.2)
    return x, dt, A, Bm, Cm


def _ssd_chunk_args(x, dt, A, Bm, Cm, cs):
    """``ssd_chunked``'s views for the intra-chunk step (L a multiple of cs):
    x / B / C as (1, H or G, nc, cs, ·), dt / cum as (1, H, nc, cs)."""
    b, L, H, _ = x.shape
    nc = L // cs
    dtc = dt.reshape(b, nc, cs, H)
    cum = torch.cumsum(dtc * A, dim=2)
    heads_first = lambda t: t.reshape(b, nc, cs, t.shape[2], t.shape[3]).permute(0, 3, 1, 2, 4)  # noqa: E731
    return heads_first(x), dtc.permute(0, 3, 1, 2), cum.permute(0, 3, 1, 2), heads_first(Bm), heads_first(Cm)


def check_ssd(dev) -> dict:
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref

    gen = torch.Generator(device=dev).manual_seed(4)
    H, P, N = 24, 64, 128
    err = 0.0
    # the intra-chunk step on ssd_chunked's views: the path's shape, then
    # ragged chunk lengths (cs = 100: tiles of 64 + 36 rows; cs = 1), then
    # one group per head; bf16 runs on the tensor cores, f32 on the SIMT cores
    for L, cs, G in ((2048, 256, 1), (300, 100, 1), (5, 1, 1), (512, 256, H)):
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_chunk_args(*_ssd_inputs(gen, dev, dtype, L, H, P, N, G), cs)
            (y, st), (y0, st0) = ops.ssd_intra_chunk(*args), ssd_chunk_ref(*args)
            e = _compare_ssd(f"ssd y {dtype} L={L} cs={cs} G={G}", y, y0)
            _compare_ssd(f"ssd state {dtype} L={L} cs={cs} G={G}", st, st0)
            if dtype == torch.bfloat16 and L == 2048:
                err = e
    # the whole scan: a ragged L (777 = 3 chunks of 256 + 9 rows) with G = 1
    # read in place against B/C expanded to H = 24 heads, with an initial
    # state; then a strong decay (cum_i - cum_j passes 100 inside a chunk)
    for L, shift, init in ((777, -1.0, True), (512, 3.0, False)):
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, A, Bm, Cm = _ssd_inputs(gen, dev, dtype, L, H, P, N, 1, dt_shift=shift)
            s0 = torch.randn((1, H, N, P), generator=gen, device=dev) if init else None
            expand = lambda t: t.expand(-1, -1, H, -1)  # noqa: E731
            y, s = ops.ssd_chunked(x, dt, A, Bm, Cm, 256, s0)
            y0, s_ref = ops.ssd_chunked_ref(x, dt, A, expand(Bm), expand(Cm), 256, s0)
            if shift > 0:  # the decay really is strong: cum_0 - cum_255 in one chunk
                cum = torch.cumsum((dt * A).reshape(1, -1, 256, H), dim=2)
                span = float((cum[:, :, 0] - cum[:, :, -1]).max())
                log(f"[kernels] strong decay: cum_i - cum_j reaches {span:.1f} inside a chunk")
                assert span > 100, span
            _compare_ssd(f"ssd_chunked y {dtype} L={L} dt_shift={shift} init={init}", y, y0)
            _compare_ssd(f"ssd_chunked state {dtype} L={L} dt_shift={shift} init={init}", s, s_ref)
    # main-path shape: one layer of a 2048-token prefill, bf16
    L, cs, dtype = 2048, 256, torch.bfloat16
    sets = [_ssd_chunk_args(*_ssd_inputs(gen, dev, dtype, L, H, P, N, 1), cs) for _ in range(4)]
    ms = time_ms(ops.ssd_intra_chunk, sets)
    plain = time_ms(ssd_chunk_ref, sets)
    n_chunks = H * (L // cs)  # (head, chunk) pairs; every B / C group row is read once
    pairs = cs * (cs + 1) // 2  # (i, j) with i >= j
    score_flops = n_chunks * 2 * pairs * N
    y_flops = n_chunks * 2 * pairs * P
    state_flops = n_chunks * 2 * cs * N * P
    bytes_moved = (L * H * P + 2 * L * N) * 2 + 2 * L * H * 4 + (L * H * P + n_chunks * N * P) * 4
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    # the bound: every product on the tensor cores at the bf16 rate, the y
    # and state products counted twice (the hi and lo halves of the f32 weights)
    tc_flops = score_flops + 2 * (y_flops + state_flops)
    t_ops = tc_flops / PEAK_FLOPS[dtype] * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    # the SIMT reckoning, kept for comparison with the f32-weight kernel:
    # the scores at the bf16 rate, the y and state products at the f32 rate
    f32_flops = y_flops + state_flops
    t_ops_old = (score_flops / PEAK_FLOPS[dtype] + f32_flops / PEAK_FLOPS[torch.float32]) * 1e3
    old_bound = max(t_ops_old, t_bytes)
    log(f"[kernels] ssd bound: {tc_flops / 1e9:.3f} GFLOP at the bf16 tensor rate {t_ops:.5f} ms; "
        f"{bytes_moved} bytes {t_bytes:.5f} ms; bound {bound:.5f} ms ({by}), kernel at {bound / ms:.1%} of it")
    log(f"[kernels] ssd bound with y and state at the f32 SIMT rate: scores {score_flops / 1e9:.3f} GFLOP at bf16 "
        f"{score_flops / PEAK_FLOPS[dtype] * 1e3:.5f} ms + {f32_flops / 1e9:.3f} GFLOP at f32 "
        f"{f32_flops / PEAK_FLOPS[torch.float32] * 1e3:.5f} ms = {t_ops_old:.5f} ms; bound {old_bound:.5f} ms, "
        f"kernel at {old_bound / ms:.1%} of it")
    return dict(
        name="ssd", route="cuda", source="src/repro_torch/kernels/csrc/ssd.cu",
        replaces="src/repro/kernels/ssd/kernel.py:58", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=None, old_bound_ms=old_bound,
        shape=(f"x (1, {L}, {H}, {P}), B/C (1, {L}, 1, {N}) bf16, cs {cs}; "
               f"{(score_flops + f32_flops) / 1e9:.2f} GFLOP ({tc_flops / 1e9:.2f} on the tensor cores)"),
    )


def kernel_phase(dev) -> list[dict]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check_hgmma()
    records = [check_rmsnorm(dev), check_flash(dev), check_decode(dev), check_ssd(dev)]
    for r in records:
        lib = "none (no single PyTorch call)" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(
            f"[kernels] {r['name']} at {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
        )
    return records


def codelet_phase(dev) -> None:
    """One codelet per kernel on a device worker: the runtime picks the
    ``cuda`` implementation, so each kernel's launch counter moves by one."""
    from repro_torch.core import SpData, SpRuntime, SpWorkerTeam
    from repro_torch.kernels.decode_attention.ops import decode_attention_codelet
    from repro_torch.kernels.flash_attention.ops import flash_attention_codelet
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_codelet
    from repro_torch.kernels.ssd.ops import ssd_codelet

    gen = torch.Generator(device=dev).manual_seed(5)
    bf = lambda *shape: _randn(gen, shape, torch.bfloat16, dev)  # noqa: E731
    q, kv = bf(1, 64, 8, 64), bf(1, 64, 8, 64)
    dt = torch.nn.functional.softplus(torch.randn((1, 300, 24), generator=gen, device=dev) - 1)
    cases = {
        "rmsnorm": (rmsnorm_codelet, (bf(16, 768), bf(768)), {}),
        "flash_attention": (flash_attention_codelet, (q, kv, kv), {}),
        "decode_attention": (
            decode_attention_codelet,
            (q[:, :1], kv, kv, torch.tensor([40], dtype=torch.int32, device=dev)), {},
        ),
        "ssd": (ssd_codelet, (bf(1, 300, 24, 64), dt, -torch.ones(24, device=dev),
                              bf(1, 300, 1, 128), bf(1, 300, 1, 128)), dict(chunk=256)),
    }
    ops = _kernel_ops()
    before = {name: ops[name].launches.count for name in cases}
    outs = {name: SpData(None) for name in cases}
    with SpRuntime(workers=SpWorkerTeam(["cuda"])) as rt:
        for name, (codelet, args, static) in cases.items():
            codelet(*(SpData(a) for a in args), outs[name], **static)
        rt.wait_all_tasks()
    torch.cuda.synchronize()
    moved = {name: ops[name].launches.count - before[name] for name in cases}
    log(f"[codelets] one codelet per kernel on a 'cuda' worker: launches {moved}")
    assert moved == {name: 1 for name in cases}, moved
    for name, out in outs.items():
        first = out.value[0] if isinstance(out.value, tuple) else out.value
        assert torch.isfinite(first.float()).all(), name


# ---------------------------------------------------------------------------
# 4-5. serving at full width
# ---------------------------------------------------------------------------

def _kernel_ops() -> dict:
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    return {"rmsnorm": rmsnorm_ops, "flash_attention": flash_ops, "decode_attention": decode_ops,
            "ssd": ssd_ops}


def _sequential_greedy(model, cfg, prompt, slot, dev, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                       gen=GEN) -> tuple[list[int], torch.Tensor, dict]:
    """Oracle (``tests/test_serving.py``'s): prefill, then a greedy
    ``decode_step`` loop.  The sequence sits in ``slot`` of a batch as wide
    as the engine's, so every matrix product has the engine's shape.
    → (tokens, the last step's logits (V,), the slot's caches after it)."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.runtime.serve import prime_cache

    logits, caches = prefill(model, {"tokens": torch.from_numpy(prompt[None, :]).to(dev)}, cfg)
    primed = prime_cache(cfg, caches, len(prompt), max_seq)
    full = init_cache(cfg, n_slots, max_seq, device=dev)
    for k in full:
        full[k][:, slot] = primed[k][:, 0]
    del primed, caches
    toks = [int(torch.argmax(logits[0, -1]))]
    tok_in = torch.zeros((n_slots, 1), dtype=torch.int32, device=dev)
    pos = torch.zeros(n_slots, dtype=torch.int32, device=dev)
    for s in range(gen - 1):
        tok_in[slot, 0] = toks[-1]
        pos[slot] = len(prompt) + s
        logits, full = decode_step(model, tok_in, full, pos, cfg)
        toks.append(int(torch.argmax(logits[slot, 0])))
    return toks, logits[slot, 0], {k: c[:, slot] for k, c in full.items()}


def _profile_decode(eng, prompts, n_iter: int = 4) -> dict:
    """One decode iteration with every slot busy: wall time (host clock, no
    profiler), then device time by kernel and the device-busy share over
    ``n_iter`` profiled iterations (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    reqs = [eng.submit(p, 3 * n_iter + 2) for p in prompts]
    eng.step()  # admissions (prefills) outside the windows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_iter
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_iter):
            eng.step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / n_iter
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    return dict(wall_ms=wall_ms, **_device_rows(prof, prof_wall_ms, n_iter))


def _device_rows(prof, prof_wall_ms: float, n_iter: int) -> dict:
    """Device time per iteration by kernel name and the busy share of the
    profiled wall time."""
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0.0)
        if t and ev.device_type.name == "CUDA":
            rows.append((ev.key[:90], t / 1e3 / n_iter))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(ms for _, ms in rows)
    return dict(profiled_wall_ms=prof_wall_ms, device_ms=device_ms,
                busy=device_ms / prof_wall_ms if prof_wall_ms else 0.0, top=rows[:12])


def _profile_prefill(model, cfg, prompt, dev, n_iter: int = 3) -> dict:
    """One prefill of ``prompt`` with nothing else running: wall time (host
    clock around a synchronised call, median of ``n_iter``), then device time
    by kernel and the busy share of one profiled call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import prefill

    batch = {"tokens": torch.from_numpy(prompt[None, :]).to(dev)}
    walls = []
    for _ in range(n_iter):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(model, batch, cfg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(model, batch, cfg)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    return dict(wall_ms=sorted(walls)[n_iter // 2], **_device_rows(prof, prof_wall_ms, 1))


def serving_phase(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine

    cfg = get_config("deepseek-7b")
    t0 = time.perf_counter()
    model = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] deepseek-7b ({cfg.n_layers} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B "
        f"params, {cfg.dtype}) initialised on the card in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in PROMPT_LENS]
    sampled_prompt = rng.integers(0, cfg.vocab, size=SAMPLED_LEN).astype(np.int32)
    warm = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in PROMPT_LENS + (SAMPLED_LEN,)]
    ops = _kernel_ops()
    torch.cuda.reset_peak_memory_stats()
    with ServeEngine(cfg, model, n_slots=N_SLOTS, max_seq=MAX_SEQ, block_size=BLOCK_SIZE,
                     device=dev) as eng:
        # warm-up wave: same lengths, other prompts (first-use costs of the
        # worker threads and of each matrix shape stay out of the TTFTs)
        t0 = time.perf_counter()
        for p in warm:
            eng.submit(p, 2)
        eng.run_until_drained()
        log(f"[serve] warm-up wave ({len(warm)} requests, 2 tokens each) took {time.perf_counter() - t0:.2f} s")
        base = (eng.prefills, eng.decode_steps, eng.restores)
        # ---- the main path: counts from 0 just before, read just after ----
        for m in ops.values():
            m.launches.reset()
        t0 = time.perf_counter()
        greedy = [eng.submit(p, GEN) for p in prompts]
        sampled = eng.submit(sampled_prompt, GEN, temperature=0.8, top_k=40, seed=7)
        eng.run_until_drained()
        # duplicates find the first wave's blocks written back: the 2048-token
        # prompt shares its 127 full blocks and re-prefills (2047 rows are not
        # block-aligned); the 321-token prompt restores 320 rows, no prefill
        dup = eng.submit(prompts[0], GEN)
        dup_restore = eng.submit(sampled_prompt, GEN)
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: m.launches.count for name, m in ops.items()}
        # --------------------------------------------------------------------
        stats = eng.stats()
        stats.update(prefills=eng.prefills - base[0], decode_steps=eng.decode_steps - base[1],
                     restores=eng.restores - base[2])
        peak = torch.cuda.max_memory_allocated()
        step_profile = _profile_decode(eng, warm)
    prefill_profile = _profile_prefill(model, cfg, prompts[0], dev)

    reqs = greedy + [sampled, dup, dup_restore]
    assert all(r.done and len(r.out_tokens) == GEN for r in reqs), "a request did not finish"
    assert stats["restores"] == 1 and stats["prefills"] == 5, f"admission paths: {stats}"
    assert stats["pool"]["shared_hits"] >= 1, f"no prefix sharing: {stats}"
    n_fwd = stats["prefills"] + stats["decode_steps"]
    want = {
        "flash_attention": cfg.n_layers * stats["prefills"],
        "decode_attention": cfg.n_layers * stats["decode_steps"],
        "rmsnorm": (2 * cfg.n_layers + 1) * n_fwd,
        "ssd": 0,  # no ssm layer in this model
    }
    log(f"[serve] launches on the main path {launches}; expected {want} from "
        f"{stats['prefills']} prefills and {stats['decode_steps']} decode steps")
    assert launches == want, "the main path did not run through every kernel as expected"
    assert all(launches[k] > 0 for k in ("flash_attention", "decode_attention", "rmsnorm"))

    n_tok = sum(len(r.out_tokens) for r in reqs)
    log(f"[serve] {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tok/s, "
        f"first token included), {stats['steps']} engine iterations, {stats['prefills']} prefills, "
        f"{stats['restores']} restores, peak device memory {peak / 2**30:.2f} GiB")
    for r in reqs:
        log(f"[serve]   prompt {len(r.prompt):5d} temp {r.temperature}: TTFT "
            f"{(r.t_first - r.t_arrival) * 1e3:.1f} ms, tokens {r.out_tokens[:8]}...")
    log(f"[serve] duplicate (prefix-shared, re-prefilled) stream equals the original's: "
        f"{dup.out_tokens == greedy[0].out_tokens}; restored request's first tokens {dup_restore.out_tokens[:8]}")

    want_toks = _sequential_greedy(model, cfg, prompts[1], 1, dev)[0]
    log(f"[serve] sequential prefill + decode_step loop for prompt {PROMPT_LENS[1]}: {want_toks}")
    assert greedy[1].out_tokens == want_toks, (greedy[1].out_tokens, want_toks)
    log("[serve] engine stream equals the sequential loop")
    sp = step_profile
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    sp["weights_bound_ms"] = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[profile] decode iteration with {N_SLOTS} busy slots: {sp['wall_ms']:.2f} ms wall "
        f"({N_SLOTS / sp['wall_ms'] * 1e3:.1f} tok/s); under the profiler {sp['profiled_wall_ms']:.2f} ms "
        f"wall, {sp['device_ms']:.2f} ms device time, device busy {sp['busy']:.1%}; reading the "
        f"{weight_bytes / 1e9:.2f} GB of weights once takes {sp['weights_bound_ms']:.2f} ms")
    for name, ms in sp["top"]:
        log(f"[profile]   {ms:8.4f} ms  {name}")
    pp = prefill_profile
    log(f"[profile] deepseek-7b prefill of {PROMPT_LENS[0]} tokens alone: {pp['wall_ms']:.2f} ms wall "
        f"(median of 3); under the profiler {pp['profiled_wall_ms']:.2f} ms wall, "
        f"{pp['device_ms']:.2f} ms device time, device busy {pp['busy']:.1%}")
    for name, ms in pp["top"]:
        log(f"[profile]   {ms:8.4f} ms  {name}")
    return dict(
        launches=launches, tok_per_s=n_tok / wall, wall_s=wall, peak_bytes=peak, stats=stats,
        ttft_ms=[(r.t_first - r.t_arrival) * 1e3 for r in reqs], decode_profile=sp,
        prefill_profile=pp,
    )


def _slot_run(eng, prompt, others) -> dict:
    """Admit ``prompt`` while ``others`` decode, into a slot that earlier
    requests left their ssm state in.  Keeps the slot's caches right after
    the admission step, and the logits and caches of the request's last
    decode step (copied as that step samples: once finished, the slot is
    still stepped while the others run)."""
    seen = {}
    sample = eng._sample_batch

    def spy(logits):  # the decode codelet's sampler, called after the cache update
        for slot, r in eng._slot_req.items():
            if r is seen.get("req"):
                seen["logits"] = logits[slot].clone()
                seen["caches"] = {k: c[:, slot].clone() for k, c in eng._caches.items()}
        return sample(logits)

    rest = [eng.submit(p, M_GEN) for p in others]
    eng.step()  # the others' admissions
    eng.step()  # their first decode step
    eng._sample_batch = spy
    try:
        req = seen["req"] = eng.submit(prompt, M_GEN)
        eng.step()  # the others' decode step, then this request's prefill and install
        slot = next(s for s, r in eng._slot_req.items() if r is req)
        installed = {k: c[:, slot].clone() for k, c in eng._caches.items()}
        eng.run_until_drained()
    finally:
        del eng._sample_batch
    assert req.done and all(r.done for r in rest)
    return dict(req=req, slot=slot, installed=installed, logits=seen["logits"], caches=seen["caches"])


def mamba2_serving_phase(dev) -> dict:
    """Full-width mamba2-130m through ``ServeEngine``: the prefill runs the
    ssd kernel once per layer and rmsnorm once per layer plus the final norm;
    decode is plain torch besides rmsnorm.  The ssm caches are not pageable,
    so the duplicate prompt re-prefills."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine

    cfg = get_config("mamba2-130m")
    gc.collect()  # the deepseek-7b phase's engine and model are cyclic garbage
    mem_base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[mamba2] mamba2-130m ({cfg.n_layers} layers, d_model {cfg.d_model}, d_state "
        f"{cfg.ssm.d_state}, {n_params / 1e9:.3f} B params, {cfg.dtype}) initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s ({mem_base} bytes allocated before it)")

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in M_PROMPT_LENS]
    sampled_prompt = rng.integers(0, cfg.vocab, size=M_SAMPLED_LEN).astype(np.int32)
    # the warm-up wave fills every slot: the profiled decode iteration reuses it
    warm_lens = M_PROMPT_LENS + (M_SAMPLED_LEN,) + M_WARM_EXTRA
    warm = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in warm_lens]
    ops = _kernel_ops()
    torch.cuda.reset_peak_memory_stats()
    with ServeEngine(cfg, model, n_slots=M_SLOTS, max_seq=M_MAX_SEQ, device=dev) as eng:
        t0 = time.perf_counter()
        for p in warm:
            eng.submit(p, 2)
        eng.run_until_drained()
        log(f"[mamba2] warm-up wave ({len(warm)} requests, 2 tokens each) took {time.perf_counter() - t0:.2f} s")
        base = (eng.prefills, eng.decode_steps, eng.restores)
        # ---- the main path: counts from 0 just before, read just after ----
        for m in ops.values():
            m.launches.reset()
        t0 = time.perf_counter()
        greedy = [eng.submit(p, M_GEN) for p in prompts]
        sampled = eng.submit(sampled_prompt, M_GEN, temperature=0.8, top_k=40, seed=7)
        eng.run_until_drained()
        dup = eng.submit(prompts[1], M_GEN)
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: m.launches.count for name, m in ops.items()}
        # --------------------------------------------------------------------
        stats = eng.stats()
        stats.update(prefills=eng.prefills - base[0], decode_steps=eng.decode_steps - base[1],
                     restores=eng.restores - base[2])
        peak = torch.cuda.max_memory_allocated() - mem_base
        # the 777-token prompt again, admitted beside 7 decoding requests
        run = _slot_run(eng, prompts[2], warm[: M_SLOTS - 1])
        step_profile = _profile_decode(eng, warm)
    prefill_profile = _profile_prefill(model, cfg, prompts[0], dev)

    reqs = greedy + [sampled, dup]
    assert all(r.done and len(r.out_tokens) == M_GEN for r in reqs), "a request did not finish"
    assert (stats["prefills"], stats["restores"], stats["pageable"]) == (6, 0, False), stats
    want = {
        "flash_attention": 0,
        "decode_attention": 0,
        "rmsnorm": (cfg.n_layers + 1) * (stats["prefills"] + stats["decode_steps"]),
        "ssd": cfg.n_layers * stats["prefills"],
    }
    log(f"[mamba2] launches on the main path {launches}; expected {want} from "
        f"{stats['prefills']} prefills and {stats['decode_steps']} decode steps")
    assert launches == want, "the main path did not run through every kernel as expected"
    assert launches["ssd"] > 0 and launches["rmsnorm"] > 0

    n_tok = sum(len(r.out_tokens) for r in reqs)
    log(f"[mamba2] {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tok/s, "
        f"first token included), {stats['steps']} engine iterations, {stats['prefills']} prefills, "
        f"{stats['restores']} restores, peak device memory {peak / 2**30:.2f} GiB ({peak} bytes)")
    for r in reqs:
        log(f"[mamba2]   prompt {len(r.prompt):5d} temp {r.temperature}: TTFT "
            f"{(r.t_first - r.t_arrival) * 1e3:.1f} ms, tokens {r.out_tokens[:8]}...")
    log(f"[mamba2] duplicate (re-prefilled) stream equals the original's: "
        f"{dup.out_tokens == greedy[1].out_tokens}")
    assert dup.out_tokens == greedy[1].out_tokens

    # greedy streams repeat one token under this seeded init, so the slot's
    # caches and logits carry the check: a stale or mixed slot differs there
    from repro_torch.models import prefill

    _, pre = prefill(model, {"tokens": torch.from_numpy(prompts[2][None, :]).to(dev)}, cfg)
    for k in ("state", "conv"):
        _compare_ssd(f"mamba2 slot {run['slot']} {k} installed by the engine vs prefill", run["installed"][k],
                     pre[k][:, 0])
    want_toks, want_logits, want_caches = _sequential_greedy(
        model, cfg, prompts[2], run["slot"], dev, M_SLOTS, M_MAX_SEQ, M_GEN
    )
    log(f"[mamba2] sequential prefill + decode_step loop for prompt {M_PROMPT_LENS[2]}: {want_toks[:8]}...")
    assert greedy[2].out_tokens == want_toks, (greedy[2].out_tokens, want_toks)
    assert run["req"].out_tokens == want_toks, (run["req"].out_tokens, want_toks)
    V = cfg.vocab
    _compare("mamba2 last decode logits, engine vs sequential loop", run["logits"][:V], want_logits[:V],
             torch.bfloat16)
    for k in ("state", "conv"):
        _compare_ssd(f"mamba2 slot {k} after the last decode step, engine vs sequential loop",
                     run["caches"][k], want_caches[k])
    log("[mamba2] engine stream, last logits and slot caches equal the sequential loop's")
    sp = step_profile
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    sp["weights_bound_ms"] = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[profile] mamba2 decode iteration with {M_SLOTS} busy slots: {sp['wall_ms']:.2f} ms wall "
        f"({M_SLOTS / sp['wall_ms'] * 1e3:.1f} tok/s); under the profiler {sp['profiled_wall_ms']:.2f} ms "
        f"wall, {sp['device_ms']:.2f} ms device time, device busy {sp['busy']:.1%}; reading the "
        f"{weight_bytes / 1e9:.3f} GB of weights once takes {sp['weights_bound_ms']:.4f} ms")
    for name, ms in sp["top"]:
        log(f"[profile]   {ms:8.4f} ms  {name}")
    pp = prefill_profile
    log(f"[profile] mamba2 prefill of {M_PROMPT_LENS[0]} tokens alone: {pp['wall_ms']:.2f} ms wall "
        f"(median of 3); under the profiler {pp['profiled_wall_ms']:.2f} ms wall, "
        f"{pp['device_ms']:.2f} ms device time, device busy {pp['busy']:.1%}")
    ssd_ms = sum(ms for name, ms in pp["top"] if "ssd_chunk" in name)
    log(f"[profile] the ssd kernel takes {ssd_ms:.3f} ms of that prefill's {pp['device_ms']:.2f} ms of device "
        f"time ({ssd_ms / pp['device_ms']:.1%})")
    for name, ms in pp["top"]:
        log(f"[profile]   {ms:8.4f} ms  {name}")
    return dict(
        launches=launches, tok_per_s=n_tok / wall, wall_s=wall, peak_bytes=peak, stats=stats,
        ttft_ms=[(r.t_first - r.t_arrival) * 1e3 for r in reqs], decode_profile=sp,
        prefill_profile=pp,
    )


# ---------------------------------------------------------------------------
# 6. whole model: card against CPU
# ---------------------------------------------------------------------------

def model_phase(dev, cfg=None, prompt_len: int = 256, limit: float = 1e-3) -> float:
    """Full width, depth cut (deepseek-7b: 2 layers), float32: logits of a
    ``prompt_len``-token prefill and 4 decode steps on the card (kernels)
    against the CPU port (plain versions).  The limit allows for sums taken
    in other orders on the two devices (TF32 off); a wrong kernel is off by
    O(1)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer, decode_step, init_params, prefill
    from repro_torch.runtime.serve import prime_cache

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfg or get_config("deepseek-7b").replace(n_layers=2, dtype="float32")
    gpu = init_params(cfg, 1, device=dev)
    cpu = Transformer(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, prompt_len)).astype(np.int32))
    worst = 0.0

    def rel(a, b) -> float:  # over the real vocab: padded classes hold -1e30
        a, b = a[..., : cfg.vocab].float().cpu(), b[..., : cfg.vocab].float()
        assert torch.isfinite(a).all()
        return float((a - b).abs().max() / b.abs().max())

    lg, cg = prefill(gpu, {"tokens": prompt.to(dev)}, cfg)
    lc, cc = prefill(cpu, {"tokens": prompt}, cfg)
    worst = max(worst, rel(lg, lc))
    size = prompt_len + 8
    cg, cc = prime_cache(cfg, cg, prompt_len, size), prime_cache(cfg, cc, prompt_len, size)
    tok = torch.argmax(lc[:, 0], dim=-1).to(torch.int32)[:, None]
    for s in range(4):
        lg, cg = decode_step(gpu, tok.to(dev), cg, prompt_len + s, cfg)
        lc, cc = decode_step(cpu, tok, cc, prompt_len + s, cfg)
        worst = max(worst, rel(lg, lc))
        tok = torch.argmax(lc[:, 0], dim=-1).to(torch.int32)[:, None]
    log(f"[model] {cfg.name} {cfg.n_layers}-layer full-width fp32, {prompt_len}-token prompt, card "
        f"vs CPU: max relative logit error {worst:.3e} (limit {limit})")
    assert worst <= limit
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = header()
    dev = torch.device("cuda")
    build_s = build_kernels()
    records = kernel_phase(dev)
    codelet_phase(dev)
    serve = serving_phase(dev)
    serve_m = mamba2_serving_phase(dev)
    model_err = model_phase(dev)
    from repro_torch.configs import get_config

    model_err_m = model_phase(
        dev, get_config("mamba2-130m").replace(n_layers=4, dtype="float32"), prompt_len=600
    )
    for r in records:  # launches on both serving paths
        r["launches"] = serve["launches"][r["name"]] + serve_m["launches"][r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    kernels = [{k: r[k] for k in keys} for r in records]
    log(f"[done] {smi}: build {build_s:.1f} s, model checks {model_err:.2e} (deepseek-7b), "
        f"{model_err_m:.2e} (mamba2-130m), {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
