"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. header   — card name and power limit (nvidia-smi), torch and CUDA versions,
              the host's cost of a kernel launch into an idle and a busy card;
2. build    — builds the hand-written kernels from ``src/repro_torch/kernels/csrc``;
3. kernels  — the HGMMA count of the flash and ssd (forward and backward)
              kernels' SASS where ``cuobjdump`` is present (the bf16 routes
              have some, the f32 routes none), the registers and spills of
              the backward kernels; each kernel against its plain PyTorch version on
              the card, at the serving paths' shapes (deepseek-7b,
              mamba2-130m, gemma-7b's head dim 256; bf16) and at edge
              shapes (fp32 and bf16; head dims up to 256), with
              kernel / plain / library times and bounds (rmsnorm also at both
              paths' decode rows, decode also at short positions; flash and
              decode at gemma-7b's heads too; decode is
              checked run to run identical and batch-invariant, the ssd bound
              is logged in both reckonings); the train path's backward
              kernels (flash attention at the paths' (1, 2048, 32, 128) and
              (1, 2048, 16, 256) and edge shapes, with the forward's lse;
              rmsnorm at (2048, 4096),
              (2048·32, 128) and the edge paths) against their plain
              versions, run to run identical, timed beside the backward of
              SDPA / F.rms_norm (the flash backward's dK/dV and dQ kernels
              also apart); the ssd backward against its plain version at
              cs 256 / 100 / 1, G = 1 and G = H, a strong decay (finite
              gradients), bf16 (tensor cores: each output's worst share of
              its limit; an unaligned input raises) and fp32 (SIMT), run to
              run identical, autograd through the scan on a ragged L, and
              timed at the mamba2 train path's shape with both reckonings
              of its bound and its three kernels apart; the other
              families' shapes: flash both ways at minicpm3-4b's MLA (1,
              2048, 40, 96 / 64) and recurrentgemma-9b's windowed MQA
              ((1, 4096 / 2048, 16, 256), 1 KV head, window 2048), decode
              on its wrapped (8, 2048, 1, 256) ring (also against the
              model's own rule on the CPU), rmsnorm at widths 256 and 768;
              the F2 digests (``[f2]``: ``tools/ssd_grad_determinism.py``,
              5 iterations); then one codelet per kernel on a device
              worker;
4. examples — the five examples of ``repro_torch.examples`` on the card
              at small step counts (the heterogeneous GEMM runs tasks on
              the card worker);
5. serving  — full-width deepseek-7b (30 layers, bf16, seeded random init)
              through ``repro_torch.serving.ServeEngine``: ragged prompts and a
              sampled request, then duplicates that take the prefix-share and
              the restore paths; launch counts show the path ran through all
              three of its kernels; one greedy request is held against a
              sequential prefill + decode loop; a decode iteration and the
              2048-token prefill alone are profiled;
   serving  — full-width gemma-7b (28 layers, 16 heads of 256, GeGLU,
              tied embeddings, bf16, seeded random init), the same requests,
              checks and profiles (``[serve-gemma]`` lines), then
              minicpm3-4b (62 layers, MLA: latent rows paged, decode in
              torch ops; ``[serve-minicpm3]``) and qwen3-moe-235b-a22b at
              full width cut to 8 layers (einsum dispatch; at decode the
              capacity 8 covers the 4 slots; ``[serve-moe]``);
6. serving  — full-width mamba2-130m (24 layers, bf16, seeded random init):
              prompts up to 4096 tokens, a sampled request and a duplicate
              (re-prefilled: ssm states are not paged); launch counts show the
              path ran through the ssd and rmsnorm kernels; a request admitted
              beside 7 decoding ones is held against prefill (its installed
              caches) and against the sequential loop (tokens, last logits
              and caches); then recurrentgemma-9b (38 layers: 12 local
              attention layers on a ring of the 2048 window, 26 RG-LRU
              layers; ``[serve-rgemma]``), the same requests and checks;
7. model    — full width cut in depth, fp32: the card's logits against the
              CPU port's (plain versions) for a prompt and decode steps, for
              deepseek-7b (2 layers), mamba2-130m (4 layers), gemma-7b
              (2 layers: the f32 routes at head dim 256), minicpm3-4b (2),
              recurrentgemma-9b (3) and qwen3-moe-235b-a22b (1);
8. train    — parity: deepseek-7b at full width and 2 layers, fp32, two
              staged train steps (B = 2, L = 128, 2 microbatches) with
              Adafactor and with AdamW on the card against the CPU port from
              the same state (loss, grad norm, parameters; exact launch
              counts); gemma-7b, minicpm3-4b (L = 256), recurrentgemma-9b
              (3 layers) and qwen3-moe (1 layer; its gradients held
              elementwise, its card optimizer fed the CPU's gradients) the
              same with Adafactor;
9. train    — deepseek-7b at full width and depth (30 layers, bf16,
              Adafactor, remat "full", logits in chunks of 1024), global
              batch (2, 2048) in 2 microbatches, 4 staged steps: finite
              losses, the schedule, exact launch counts of the four train
              kernels, step time, tokens/s, model TFLOP/s, peak memory; one
              profiled step; a nonfinite step that leaves every bit as it
              was; then gemma-7b the same way at its full 28 layers
              (``[train-gemma]``: no rollback), minicpm3-4b at its 62,
              recurrentgemma-9b at its 38 layers and qwen3-moe cut to 2 (3
              steps each; model FLOPs over the active parameters);
10. train   — mamba2-130m: parity at full width and 2 layers in fp32 (B =
              2, L = 512, 2 microbatches, AdamW) against the CPU port, then
              the full 24 layers in bf16 (AdamW, remat "full"), global
              batch (8, 2048) in 2 microbatches, 4 staged steps: finite
              losses, exact ssd / ssd_bwd / rmsnorm / rmsnorm_bwd launch
              counts, step time, tokens/s, peak memory, one profiled step;
11. spec    — full-width deepseek-7b again (seed 0) cut to 12 layers, the serving phase's
              geometry and requests through ``ServeEngine`` with
              speculative decoding at k = 4: the 1-layer shrunken draft,
              the same with two forced rollbacks, and the target as its own
              draft; every stream (the sampled one too) equals the plain
              engine's, the self draft's greedy accept rate is 1.0, launch
              counts are exact (draft feeds × draft layers + verify
              sub-steps × 12 decode attentions); accept rate, tokens a
              round, round wall ms, tokens/s beside the plain engine's and
              one profiled round's device busy share;
12. load    — ``run_load`` on the same model (16 requests at 2/s, prompts of
              128-2048 tokens, a quarter duplicates): continuous, drain, and
              continuous with the 1-layer draft; equal output checksums,
              exact launch counts; TTFT and ITL p50 / p99, tokens/s;
13. ckpt    — deepseek-7b at full width and 4 layers (bf16, Adafactor),
              (2, 2048) in 2 microbatches, through the train launcher's
              loop and ``CheckpointManager`` calls: two unbroken 4-step runs (one
              saving every 2 steps), then a fresh state resumed from step 2;
              the restored state bit for bit the saved one, the resumed run
              equal to the unbroken one (or within two unbroken runs'
              spread); save, commit and restore times.  The checkpoint
              directory (``_smoke_ckpt/``) is removed at the end;
14. comm    — communication in the task graph, payloads of mamba2-130m's
              parameter count in float32 (0.52 GB a rank), every result
              bit for bit and on the card: (a) four ranks on one
              ``ChannelHub`` (eager runtimes with a ``cuda`` worker, groups
              on the card): ring all-reduce sum and mean with and without
              4 MiB pipelining, the all-gather, the hierarchical all-reduce
              at 2 × 2, a bf16 ring, and a tensor written behind a long
              kernel that arrives as written (hub and sockets); (b) rank
              processes over the socket transport: ``run_ring_reduce`` at
              2 and 4 ranks, ``run_collective`` all-gather and hierarchical,
              the legacy star at 2 ranks; wall time, bus bandwidth and the
              D2H time apart; (c) ``run_elastic_ring`` and
              ``run_elastic_train`` at 3 ranks with one SIGKILLed: the
              survivors equal their oracles, detection latency, re-roll
              time, the card's memory freed; (d) ``launch.train.main`` on
              mamba2-130m at full width with ``--fail-at 2:1
              --bench-out``: the one-device line, losses equal to a run
              without the flag, the JSON, exact launch counts.

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
# qwen3-moe-235b-a22b's fixed depth cuts (full width): it serves 8 of its 94
# layers (21.15 B parameters, 42.3 GB in bf16) and trains 2
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS = 8, 2


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


def launch_cost(n: int = 200) -> tuple[float, float]:
    """Host time of one small kernel launch, in µs (median of ``n``), into
    an idle card and into a busy one (queued behind ``torch.cuda._sleep``).
    A host-bound step pays the first on every launch that finds the card
    idle, so a faster kernel can lengthen such a step's wall time."""
    z = torch.zeros(1024, device="cuda")
    z.add_(1.0)
    torch.cuda.synchronize()
    idle = []
    for _ in range(n):
        torch.cuda.synchronize()
        time.sleep(2e-4)
        t0 = time.perf_counter()
        z.add_(1.0)
        idle.append(time.perf_counter() - t0)
    torch.cuda._sleep(2_000_000_000)
    busy = []
    for _ in range(n):
        t0 = time.perf_counter()
        z.add_(1.0)
        busy.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    idle_us, busy_us = float(np.median(idle)) * 1e6, float(np.median(busy)) * 1e6
    log(f"[header] a kernel launch costs the host {idle_us:.1f} us into an idle card, {busy_us:.1f} us "
        f"into a busy one (median of {n})")
    return idle_us, busy_us


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
             (37, 128), (5, 16), (3, 37), (7, 12288),
             # minicpm3-4b's latent norms: kv_norm (256) and q_norm (768) rows
             (2048, 256), (2048, 768), (4, 256),
             # qwen3-moe-235b-a22b's q-norm rows at a 2048-token prefill
             (2048 * QWEN_HEADS, 128))
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
    for T, D in ((2048, 4096), (4, 4096), (8, 768), (2048, 256), (2048, 768)):
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
    for T, D in ((2048, 256), (2048, 768)):
        times[(T, D)]["shape"] = f"x ({T}, {D}) bf16"
        x = _randn(gen, (T, D), dtype, dev)
        s = _randn(gen, (D,), dtype, dev, 0.1)
        times[(T, D)]["max_abs_err"] = _compare(f"rmsnorm {dtype} T={T} D={D} (timed shape)", ops.rmsnorm(x, s),
                                                rmsnorm_ref(x, s), dtype)
    T, D = 2048, 4096
    return dict(
        name="rmsnorm", route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm/kernel.py:27", max_abs_err=err, **times[(T, D)],
        shape=f"x ({T}, {D}) bf16", kv_norm=times[(2048, 256)], q_norm=times[(2048, 768)],
    )


def _pairs(Lq, Lk, causal, window, q_offset) -> int:
    """(query, key) pairs the mask keeps: the work this input needs."""
    qpos = torch.arange(Lq, dtype=torch.int64) + q_offset
    hi = torch.clamp(qpos + 1, max=Lk) if causal else torch.full_like(qpos, Lk)
    lo = torch.clamp(qpos - window + 1, min=0) if window else torch.zeros_like(qpos)
    return int(torch.clamp(hi - lo, min=0).sum())


def _hgmma_counts() -> dict | None:
    """HGMMA (wgmma) instructions in the SASS of each flash-attention
    (forward and backward) and ssd (forward and backward) kernel of the
    built library, by ``cuobjdump -sass``; None where the tool is missing."""
    from repro_torch.kernels import dispatch

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(dispatch.build())], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            # the name after its length digits, not the source file's name that the
            # anonymous namespace's mangling holds (``..._ssd_bwd_cu_<hash>...``)
            m = re.search(r"(?<=\d)(flash_(?:fwd|bwd)_\w*?kernel|ssd_(?:chunk|bwd)_\w*?kernel)(?:I(\w*?)E+v)?",
                          line)
            fn = (f"{m.group(1)}<{m.group(2)}>" if m.group(2) else m.group(1)) if m else None
            if fn:
                counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    return counts


def check_hgmma() -> dict | None:
    """The bf16 routes of flash and ssd (forward and backward) run on the
    tensor cores (HGMMA in their SASS); the f32 routes, the flash
    backward's D pass and the ssd backward's conversion and dcum passes do
    not."""
    counts = _hgmma_counts()
    if counts is None:
        log("[kernels] cuobjdump not on this machine: HGMMA counts not taken")
        return None
    log("[kernels] HGMMA instructions in the SASS: "
        + ", ".join(f"{k}: {v}" for k, v in counts.items()))
    tc = [k for k in counts if "wgmma" in k]
    simt = [k for k in counts if "wgmma" not in k]
    for prefix in ("ssd_chunk_wgmma", "flash_fwd_wgmma", "flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma",
                   "ssd_bwd_wgmma", "flash_bwd_dkdv_wgmma256", "flash_bwd_dq_wgmma256"):
        assert any(k.startswith(prefix) for k in tc), (prefix, counts)
    # the padded head dim 256 of the forward: flash_fwd_wgmma_kernel<256, 256>
    assert any(k.startswith("flash_fwd_wgmma") and "256" in k for k in tc), counts
    for prefix in ("flash_bwd_dkdv_kernel", "ssd_bwd_kernel"):
        assert any(k.startswith(prefix) for k in simt), (prefix, counts)
    assert all(counts[k] > 0 for k in tc) and all(counts[k] == 0 for k in simt), counts
    return counts


# the kernels whose registers and spills the kernel phase prints
RESOURCE_KERNELS = ("flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel", "ssd_bwd_kernel",
                    "ssd_bwd_wgmma_kernel", "flash_fwd_wgmma_kernel", "flash_bwd_dkdv_wgmma256_kernel",
                    "flash_bwd_dq_wgmma256_kernel", "flash_fwd_kernel", "flash_bwd_dkdv_kernel",
                    "flash_bwd_dq_kernel", "decode_kernel")


def resource_usage() -> dict:
    """Registers and spill bytes of each instantiation of RESOURCE_KERNELS:
    ptxas's report from the build (``-Xptxas=-v``) and ``cuobjdump
    -res-usage`` of the built library where the tool is present."""
    from repro_torch.kernels import dispatch

    usage, fn = {}, None
    for line in dispatch.build_log().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            fn = m.group(1)
            continue
        if fn and any(k in fn for k in RESOURCE_KERNELS):
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                usage.setdefault(fn, {}).update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                usage.setdefault(fn, {})["registers"] = int(m.group(1))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(tool).exists():
        res = subprocess.run([tool, "-res-usage", str(dispatch.build())], capture_output=True, text=True,
                             check=True, timeout=300).stdout.splitlines()
        for i, line in enumerate(res):
            m = re.search(r"Function (\w+):", line)
            if m and any(k in m.group(1) for k in RESOURCE_KERNELS) and i + 1 < len(res):
                usage.setdefault(m.group(1), {})["res_usage"] = res[i + 1].strip()
    for name, u in usage.items():
        log(f"[kernels] resources of {name}: {u}")
    assert all(any(k in n for n in usage) for k in RESOURCE_KERNELS), usage
    return usage


# gemma-7b's attention: 16 heads of 256 (MHA), the kernels' padded head dim 256
G_HEADS, G_DIM = 16, 256
# (B, Lq, Lk, H, KH, Dh, Dv, causal, window, q_offset) of the new families'
# flash paths: minicpm3-4b's MLA prefill, recurrentgemma-9b's 4096-token one
MLA_FLASH = (1, 2048, 2048, 40, 40, 96, 64, True, None, 0)
RG_FLASH = (1, 4096, 4096, 16, 1, 256, 256, True, 2048, 0)
RG_FLASH_BWD = (1, 2048, 2048, 16, 1, 256, 256, True, 2048, 0)
# qwen3-moe-235b-a22b's prefill and train path: 64 query heads on 4 KV heads
# of 128 (a group of 16)
QWEN_FLASH = (1, 2048, 2048, 64, 4, 128, 128, True, None, 0)
QWEN_HEADS, QWEN_KV_HEADS = 64, 4
# recurrentgemma-9b's decode ring (its window) and the serving phase's last
# positions on it: 4096 + 31 and 2048 + 31 wrapped, 808 / 131 / 1031 not,
# 4095, 2047 and 2500 beside them
RG_RING = 2048
RG_DECODE_POS = [4127, 2079, 808, 131, 1031, 4095, 2047, 2500]


def _window_mask(L: int, window, dev) -> torch.Tensor:
    """(L, L) bool: key j visible to query i (causal, within ``window``)."""
    i = torch.arange(L, device=dev)[:, None]
    j = torch.arange(L, device=dev)[None, :]
    return (j <= i) & (i - j < window)


def _flash_times(gen, dev, B, L, H, D, KH=None, Dv=None, window=None) -> dict:
    """Kernel, plain and SDPA times of the causal bf16 forward at (B, L, H,
    D) with KH key / value heads of value dim Dv (``window`` keys at most),
    the bound of the work this input needs, and whether two runs give the
    same bits.  SDPA takes Dv != D as it is, GQA expanded and a window as
    an explicit mask."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    KH, Dv = KH or H, Dv or D
    dtype = torch.bfloat16
    kw = dict(causal=True, window=window)
    sets = [(_randn(gen, (B, L, H, D), dtype, dev), _randn(gen, (B, L, KH, D), dtype, dev),
             _randn(gen, (B, L, KH, Dv), dtype, dev)) for _ in range(2)]
    first = ops.flash_attention(*sets[0], **kw)
    same = all(torch.equal(ops.flash_attention(*sets[0], **kw), first) for _ in range(2))
    ms = time_ms(lambda q, k, v: ops.flash_attention(q, k, v, **kw), sets)
    plain = time_ms(lambda q, k, v: attention_ref(q, k, v, **kw), sets)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    heads = lambda t: t.transpose(1, 2).repeat_interleave(H // KH, dim=1) if KH != H else t.transpose(1, 2)  # noqa: E731
    lib_sets = [(q.transpose(1, 2), heads(k), heads(v)) for q, k, v in sets]
    if window is not None and window < L:
        mask = _window_mask(L, window, dev)
        lib = time_ms(lambda q, k, v: sdpa(q, k, v, attn_mask=mask), lib_sets)
    else:
        lib = time_ms(lambda q, k, v: sdpa(q, k, v, is_causal=True), lib_sets)
    pairs = _pairs(L, L, True, window, 0)
    flops = 2 * B * H * (D + Dv) * pairs
    bound, by = _bound(B * L * (H * D + KH * D + KH * Dv + H * Dv) * 2, flops, dtype)
    label = f"({B}, {L}, {H}, {D}" + (f" / {Dv}" if Dv != D else "") + ")" + (f", KH {KH}" if KH != H else "") \
        + (f", window {window}" if window else "")
    log(f"[kernels] flash at {label} bf16 causal: {flops / 1e9:.2f} GFLOP, kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s), SDPA {lib:.4f} ms (kernel / SDPA {ms / lib:.2f}), plain {plain:.4f} "
        f"ms, bound {bound:.4f} ms ({by}, {bound / ms:.1%} of it); run to run identical: {same}")
    assert same, f"flash at {label}: not deterministic"
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                shape=f"q/k/v {label} bf16 causal")


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
        # padded to 256: gemma-7b's path, then 256 / 192 / 136 with a ragged
        # L, GQA, a window, offset queries, Dh != Dv
        (1, 2048, 2048, G_HEADS, G_HEADS, G_DIM, G_DIM, True, None, 0),
        (2, 777, 777, 8, 2, 256, 256, True, 300, 0),
        (1, 333, 900, 8, 8, 192, 192, True, None, 567),
        (1, 130, 130, 4, 1, 136, 136, False, None, 0),
        (1, 65, 65, 4, 4, 256, 128, True, None, 0),
        # the other families' paths: minicpm3-4b's MLA (Dk 96 != Dv 64, 40
        # heads), recurrentgemma-9b's local attention (16 heads of 256 on 1
        # KV head, window 2048) at its prefill and train lengths
        MLA_FLASH, RG_FLASH, (1, 2048, 2048, 16, 1, 256, 256, True, 2048, 0),
        QWEN_FLASH,  # qwen3-moe-235b-a22b's prefill
    ]
    err = err256 = 0.0
    errs = {}
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
            if dtype == torch.bfloat16:
                errs[(B, Lq, Lk, H, KH, Dh, Dv, causal, window, q_off)] = e
            if Lq == 2048 and dtype == torch.bfloat16 and (H, KH) in ((32, 32), (G_HEADS, G_HEADS)):
                if Dh == G_DIM:
                    err256 = e
                else:
                    err = e
    # an MLA-shaped call as the model makes it: q and k joined by torch.cat
    # from the nope and rope parts, v from the latent's product
    B, L, H = 1, 2048, 40
    q = torch.cat([_randn(gen, (B, L, H, 64), torch.bfloat16, dev), _randn(gen, (B, L, H, 32), torch.bfloat16, dev)], -1)
    kr = _randn(gen, (B, L, 1, 32), torch.bfloat16, dev).expand(B, L, H, 32)
    k = torch.cat([_randn(gen, (B, L, H, 64), torch.bfloat16, dev), kr], -1)
    v = (_randn(gen, (B, L, 256), torch.bfloat16, dev) @ _randn(gen, (256, H * 64), torch.bfloat16, dev, 0.0625)).view(B, L, H, 64)
    _compare("flash bf16 MLA q / k from torch.cat, v a view of a product", ops.flash_attention(q, k, v, causal=True),
             attention_ref(q, k, v, causal=True), torch.bfloat16)
    main = _flash_times(gen, dev, 1, 2048, 32, 128)
    shapes = {"d256": _flash_times(gen, dev, 1, 2048, G_HEADS, G_DIM),
              "mla": _flash_times(gen, dev, 1, 2048, 40, 96, Dv=64),
              "rgemma": _flash_times(gen, dev, 1, 4096, 16, 256, KH=1, window=2048),
              "qwen": _flash_times(gen, dev, 1, 2048, QWEN_HEADS, 128, KH=QWEN_KV_HEADS)}
    shapes["d256"]["max_abs_err"] = err256
    shapes["mla"]["max_abs_err"] = errs[MLA_FLASH]
    shapes["rgemma"]["max_abs_err"] = errs[RG_FLASH]
    shapes["qwen"]["max_abs_err"] = errs[QWEN_FLASH]
    return dict(
        name="flash_attention", route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:111", max_abs_err=err, **shapes, **main,
    )


def _decode_times(gen, dev, H, D, pos_l, B=N_SLOTS, S=MAX_SEQ, KH=None) -> dict:
    """Kernel, plain and SDPA (masked) times of bf16 decode against a (B, S,
    KH, D) cache (a ring when a position passes S) at positions ``pos_l``,
    and the bound of the bytes these positions need."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    KH, dtype = KH or H, torch.bfloat16
    sets = [
        (_randn(gen, (B, 1, H, D), dtype, dev), _randn(gen, (B, S, KH, D), dtype, dev),
         _randn(gen, (B, S, KH, D), dtype, dev), torch.tensor(pos_l, dtype=torch.int32, device=dev))
        for _ in range(2)
    ]
    pos = sets[0][3]
    ms = time_ms(ops.decode_attention, sets)
    plain = time_ms(decode_attention_ref, sets)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    valid = (torch.arange(S, device=dev)[None, :] < torch.clamp(pos + 1, max=S)[:, None])[:, None, None, :]
    heads = lambda t: t.transpose(1, 2).repeat_interleave(H // KH, dim=1)  # noqa: E731
    lib_sets = [(q.transpose(1, 2), heads(k), heads(v), p) for q, k, v, p in sets]
    lib = time_ms(lambda q, k, v, p: sdpa(q, k, v, attn_mask=valid), lib_sets)
    n_valid = sum(min(p + 1, S) for p in pos_l)
    bytes_moved = (2 * B * H * D + 2 * n_valid * KH * D) * 2 + B * 4
    bound, by = _bound(bytes_moved, 4 * n_valid * H * D, dtype)
    log(f"[kernels] decode at pos {pos_l} (q ({B}, 1, {H}, {D}), cache ({B}, {S}, {KH}, {D}) bf16): kernel "
        f"{ms:.4f} ms, SDPA {lib:.4f} ms, plain {plain:.4f} ms, bound {bound:.5f} ms ({by}, {bound / ms:.1%} of it)")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                shape=f"q ({B}, 1, {H}, {D}), cache ({B}, {S}, {KH}, {D}) bf16, pos {pos_l}")


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
        # padded to 256: gemma-7b's path, then GQA at 192, a ring at 136, and
        # rows of 130 (260 bytes in bf16, 520 in f32: element-wise loads)
        (N_SLOTS, MAX_SEQ, G_HEADS, G_HEADS, G_DIM, main_pos, (torch.bfloat16, torch.float32)),
        (4, 1000, 16, 4, 192, [0, 999, 500, 63], (torch.bfloat16, torch.float32)),
        (4, 256, 8, 2, 136, [1000, 10, 255, 256], (torch.bfloat16, torch.float32)),
        (3, 300, 4, 2, 130, [299, 0, 130], (torch.bfloat16, torch.float32)),
        # recurrentgemma-9b's ring: 8 slots of 2048 on 1 KV head of 256,
        # positions that wrapped, one that did not, one at the boundary
        (M_SLOTS, RG_RING, 16, 1, 256, RG_DECODE_POS, (torch.bfloat16, torch.float32)),
        # qwen3-moe-235b-a22b's path: 64 query heads on 4 KV heads of 128
        (N_SLOTS, MAX_SEQ, QWEN_HEADS, QWEN_KV_HEADS, 128, main_pos, (torch.bfloat16, torch.float32)),
    ]
    err = err256 = 0.0
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
            if S == MAX_SEQ and dtype == torch.bfloat16 and H != QWEN_HEADS:
                if D == G_DIM:
                    err256 = e
                else:
                    err = e
            if S == RG_RING:
                # the model's own rule on the CPU (models/attention.py::decode_attention)
                from repro_torch.models.attention import decode_attention

                cpu = decode_attention(q.cpu(), k.cpu(), v.cpu(), pos.cpu())
                e = _compare(f"decode {dtype} ring of {S} at {pos_l} vs models.attention.decode_attention "
                             "on the CPU", ops.decode_attention(q, k, v, pos), cpu.to(dev), dtype)
                if dtype == torch.bfloat16:
                    err_ring = e
            if H == QWEN_HEADS and dtype == torch.bfloat16:
                err_qwen = e
    # run to run identical, and batch-invariant: each sequence beside empty
    # slots (positions 0) equals itself beside the live ones, bit for bit;
    # deepseek-7b's heads (and GQA), then gemma-7b's, then qwen3-moe's
    B, S, dtype = N_SLOTS, MAX_SEQ, torch.bfloat16
    for H, KH, D in ((32, 32, 128), (32, 8, 128), (G_HEADS, G_HEADS, G_DIM), (G_HEADS, 4, G_DIM),
                     (QWEN_HEADS, QWEN_KV_HEADS, 128)):
        q = _randn(gen, (B, 1, H, D), dtype, dev)
        k, v = (_randn(gen, (B, S, KH, D), dtype, dev) for _ in range(2))
        live = torch.tensor(main_pos, dtype=torch.int32, device=dev)
        first = ops.decode_attention(q, k, v, live)
        assert all(torch.equal(ops.decode_attention(q, k, v, live), first) for _ in range(3)), "not deterministic"
        for b in range(B):
            alone = torch.zeros_like(live)
            alone[b] = live[b]
            assert torch.equal(ops.decode_attention(q, k, v, alone)[b], first[b]), f"batch-variant at b={b}"
        log(f"[kernels] decode H={H} KH={KH} D={D}: run to run identical and batch-invariant at pos {main_pos}")
    # times at the path's positions and at short ones, then at gemma-7b's heads
    main = _decode_times(gen, dev, 32, 128, main_pos)
    short = _decode_times(gen, dev, 32, 128, [15, 100, 31, 64])
    d256 = _decode_times(gen, dev, G_HEADS, G_DIM, main_pos)
    d256["max_abs_err"] = err256
    ring = _decode_times(gen, dev, 16, 256, RG_DECODE_POS, B=M_SLOTS, S=RG_RING, KH=1)
    ring["max_abs_err"] = err_ring
    qwen = _decode_times(gen, dev, QWEN_HEADS, 128, main_pos, KH=QWEN_KV_HEADS)
    qwen["max_abs_err"] = err_qwen
    return dict(
        name="decode_attention", route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:81", max_abs_err=err, **main,
        short=short, d256=d256, rgemma=ring, qwen=qwen,
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


def profiled_calls(fn, iters: int = 10) -> dict:
    """Device time of one call of ``fn``, in all (``device_ms``) and by
    kernel (``top``): ``_device_rows`` of ``iters`` calls under
    ``torch.profiler``, warmed up first.  For calls that a CUDA graph does
    not capture (an autograd backward through a library op) and to split a
    call by kernel; like a graph replay, it leaves out the host's gaps
    between launches, which events around eager calls would count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return _device_rows(prof, 0.0, iters)


# backward outputs are float32 sums over a sequence (dK, dV over queries, dQ
# over keys; dscale over rows), whatever the dtype, so their rounding error
# scales with the output's magnitude: atol·max|plain| + rtol·|plain|
BWD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


def _compare_bwd(name, got, want, dtype) -> float:
    scale = float(want.float().abs().max())
    atol, rtol = BWD_TOL[dtype]
    return _compare(f"{name} (max|plain| {scale:.3e})", got, want, None,
                    dict(atol=atol * scale, rtol=rtol))


def _flash_bwd_times(gen, dev, B, L, H, D, KH=None, Dv=None, window=None) -> dict:
    """The causal bf16 backward at (B, L, H, D) with KH key / value heads of
    value dim Dv (``window`` keys at most): kernel, plain and SDPA backward
    times, the dK/dV and dQ kernels apart, the forward with and without
    lse, and the bound of the 5 products the unmasked pairs need."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    KH, Dv = KH or H, Dv or D
    dtype = torch.bfloat16
    kw = dict(causal=True, window=window)
    sets = []
    for _ in range(2):
        q, k = _randn(gen, (B, L, H, D), dtype, dev), _randn(gen, (B, L, KH, D), dtype, dev)
        v, do = _randn(gen, (B, L, KH, Dv), dtype, dev), _randn(gen, (B, L, H, Dv), dtype, dev)
        out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
        sets.append((q, k, v, out, lse, do))
    ms = time_ms(lambda *a: ops.flash_attention_bwd(*a, **kw), sets)
    parts = dict(profiled_calls(lambda: ops.flash_attention_bwd(*sets[0], **kw))["top"])
    plain = time_ms(lambda *a: attention_bwd_ref(*a, **kw), sets[:1], iters=3)
    # the serving forward (lse not asked for) against the train forward
    fwd_sets = [s[:3] for s in sets]
    fwd_ms = time_ms(lambda q, k, v: ops.flash_attention(q, k, v, **kw), fwd_sets)
    fwd_lse_ms = time_ms(lambda q, k, v: ops.flash_attention(q, k, v, return_lse=True, **kw), fwd_sets)
    # PyTorch's call: the backward of SDPA alone (its forward built once;
    # GQA expanded, a window shorter than L as an explicit mask)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    heads = lambda t: t.transpose(1, 2).repeat_interleave(H // KH, dim=1) if KH != H else t.transpose(1, 2)  # noqa: E731
    qt = sets[0][0].transpose(1, 2).detach().requires_grad_()
    kt, vt = (heads(t).detach().requires_grad_() for t in sets[0][1:3])
    if window is not None and window < L:
        o = sdpa(qt, kt, vt, attn_mask=_window_mask(L, window, dev))
    else:
        o = sdpa(qt, kt, vt, is_causal=True)
    dot = sets[0][5].transpose(1, 2)
    lib = profiled_calls(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True))["device_ms"]
    pairs = _pairs(L, L, True, window, 0)
    # 5 products over the unmasked pairs (the kernels run 7): S and dQ, dK
    # at D; dP and dV at Dv
    flops = 2 * B * H * (3 * D + 2 * Dv) * pairs
    # q, k, v, out, dout read, dq, dk, dv written, lse read
    bound, by = _bound(2 * B * L * (2 * H * D + 2 * KH * D + 2 * KH * Dv + 2 * H * Dv) + B * H * L * 4, flops,
                       dtype)
    label = f"({B}, {L}, {H}, {D}" + (f" / {Dv}" if Dv != D else "") + ")" + (f", KH {KH}" if KH != H else "") \
        + (f", window {window}" if window else "")
    D = f"{D} / {Dv}" if Dv != D else D
    log(f"[kernels] flash bwd at {label} bf16 causal: {flops / 1e9:.2f} GFLOP, kernel "
        f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), SDPA backward {lib:.4f} ms (kernel / library "
        f"{ms / lib:.2f}), plain {plain:.4f} ms, bound {bound:.4f} ms ({by}, {bound / ms:.1%} of it)")
    # the dK/dV and dQ kernels apart: dK/dV runs 4 of the 7 products, dQ 3
    dkdv = sum(t for n, t in parts.items() if "dkdv" in n)
    dq = sum(t for n, t in parts.items() if "dq_" in n)
    dot = sum(t for n, t in parts.items() if "dot" in n)
    log(f"[kernels] flash bwd kernels apart at head dim {D} (profiler, 10 calls): dK/dV {dkdv:.4f} ms "
        f"({flops * 4 / 7 / dkdv / 1e9:.1f} TFLOP/s of its 4 products), dQ {dq:.4f} ms "
        f"({flops * 3 / 7 / dq / 1e9:.1f} TFLOP/s of its 3), D pass {dot:.4f} ms; "
        + ", ".join(f"{n[:60]} {t:.4f}" for n, t in parts.items()))
    log(f"[kernels] flash fwd at ({B}, {L}, {H}, {D}): {fwd_ms:.4f} ms without lse (serving), "
        f"{fwd_lse_ms:.4f} ms with it (train)")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib,
                fwd_ms=fwd_ms, fwd_lse_ms=fwd_lse_ms, dkdv_ms=dkdv, dq_ms=dq, dot_ms=dot,
                shape=f"q/k/v/out/dout {label} bf16 causal")


def check_flash_bwd(dev) -> dict:
    """The forward's lse and the backward kernel against the plain versions
    on the same out and lse, run to run identical; times at the paths'
    shapes (one 2048-token sequence: deepseek-7b's 32 heads of 128,
    gemma-7b's 16 heads of 256)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_fwd_ref

    gen = torch.Generator(device=dev).manual_seed(11)
    cases = [  # (B, Lq, Lk, H, KH, Dh, Dv, causal, window, q_offset)
        (1, 2048, 2048, 32, 32, 128, 128, True, None, 0),  # the path's
        (1, 1000, 1000, 32, 8, 128, 128, True, 256, 0),  # GQA + window
        (2, 777, 777, 8, 8, 64, 64, True, None, 0),
        (1, 65, 700, 8, 2, 128, 128, True, None, 635),  # offset queries, Lq != Lk
        (1, 1, 65, 4, 4, 64, 64, True, None, 64),  # one query row
        (1, 300, 300, 4, 4, 128, 128, False, None, 0),
        (1, 500, 500, 8, 8, 96, 96, True, None, 0),  # head dim padded to 128
        # padded to 256 (the role-split bf16 kernels, 32-row f32 tiles):
        # gemma-7b's path, GQA + window at 192, offset queries, a ragged
        # non-causal 136, Dv < Dh
        (1, 2048, 2048, G_HEADS, G_HEADS, G_DIM, G_DIM, True, None, 0),
        (1, 1000, 1000, 16, 4, 192, 192, True, 256, 0),
        (1, 65, 700, 4, 1, 256, 256, True, None, 635),
        (2, 333, 333, 4, 4, 136, 136, False, None, 0),
        (1, 300, 300, 4, 2, 256, 64, True, None, 0),
        # the other families' train paths: minicpm3-4b's MLA, recurrentgemma-9b's
        # local attention at (2, 2048) in 2 microbatches (the window covers L)
        MLA_FLASH, RG_FLASH_BWD,
        QWEN_FLASH,  # qwen3-moe-235b-a22b's, at (2, 2048) in 2 microbatches
    ]
    err = err256 = 0.0
    errs: dict = {}
    for B, Lq, Lk, H, KH, Dh, Dv, causal, window, q_off in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q = _randn(gen, (B, Lq, H, Dh), dtype, dev)
            k = _randn(gen, (B, Lk, KH, Dh), dtype, dev)
            v = _randn(gen, (B, Lk, KH, Dv), dtype, dev)
            do = _randn(gen, (B, Lq, H, Dv), dtype, dev)
            kw = dict(causal=causal, window=window, q_offset=q_off)
            label = f"{dtype} B={B} Lq={Lq} Lk={Lk} H={H} KH={KH} Dh={Dh} Dv={Dv} {kw}"
            out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
            want_out, want_lse = attention_fwd_ref(q, k, v, **kw)
            _compare(f"flash fwd lse {label}", lse, want_lse, torch.float32,
                     dict(atol=1e-4 if dtype == torch.float32 else 1e-3, rtol=0))
            _compare(f"flash fwd out (with lse) {label}", out, want_out, dtype)
            got = ops.flash_attention_bwd(q, k, v, want_out, want_lse, do, **kw)
            want = attention_bwd_ref(q, k, v, want_out, want_lse, do, **kw)
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                e = _compare_bwd(f"flash bwd {name} {label}", g, w, dtype)
                case = (B, Lq, Lk, H, KH, Dh, Dv, causal, window, q_off)
                if dtype == torch.bfloat16:
                    errs[case] = max(errs.get(case, 0.0), e)
                if Lq == 2048 and dtype == torch.bfloat16 and (H, KH) in ((32, 32), (G_HEADS, G_HEADS)):
                    if Dh == G_DIM:
                        err256 = max(err256, e)
                    else:
                        err = max(err, e)
            again = ops.flash_attention_bwd(q, k, v, want_out, want_lse, do, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), f"flash bwd {label}: not deterministic"
            del q, k, v, do, out, lse, want_out, want_lse, got, want, again
    log("[kernels] flash bwd: run to run identical in every case")
    main = _flash_bwd_times(gen, dev, 1, 2048, 32, 128)
    shapes = {"d256": _flash_bwd_times(gen, dev, 1, 2048, G_HEADS, G_DIM),
              "mla": _flash_bwd_times(gen, dev, 1, 2048, 40, 96, Dv=64),
              "rgemma": _flash_bwd_times(gen, dev, 1, 2048, 16, 256, KH=1, window=2048),
              "qwen": _flash_bwd_times(gen, dev, 1, 2048, QWEN_HEADS, 128, KH=QWEN_KV_HEADS)}
    shapes["d256"]["max_abs_err"] = err256
    shapes["mla"]["max_abs_err"] = errs[MLA_FLASH]
    shapes["rgemma"]["max_abs_err"] = errs[RG_FLASH_BWD]
    shapes["qwen"]["max_abs_err"] = errs[QWEN_FLASH]
    return dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/attention.py:139 (no Pallas kernel: JAX differentiates the jnp custom VJP)",
        max_abs_err=err, **shapes, **main,
    )


def check_rmsnorm_bwd(dev) -> dict:
    """The backward kernel against the plain version on the path's rows
    (deepseek-7b: D = 4096; q/k-norm rows of 128 when qk_norm is set) and
    the edge paths, run to run identical; times at (2048, 4096) bf16."""
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref

    gen = torch.Generator(device=dev).manual_seed(12)
    err = 0.0
    # then minicpm3-4b's latent norms (kv_norm 256, q_norm 768) and
    # qwen3-moe-235b-a22b's q-norm rows (64 heads of 128) at 2048 tokens
    cases = ((2048, 4096), (2048 * 32, 128), (333, 37), (7, 12288), (1, 4096), (100, 768),
             (2048, 256), (2048, 768), (2048 * QWEN_HEADS, 128))
    for dtype in (torch.bfloat16, torch.float32):
        for T, D in cases + ((50, -768),):
            if D < 0:  # rows one element into a buffer: the scalar path
                D = -D
                x = _randn(gen, (T * D + 1,), dtype, dev)[1:].view(T, D)
                dy = _randn(gen, (T * D + 1,), dtype, dev)[1:].view(T, D)
                label = f"{dtype} T={T} D={D} unaligned rows"
            else:
                x, dy = _randn(gen, (T, D), dtype, dev), _randn(gen, (T, D), dtype, dev)
                label = f"{dtype} T={T} D={D}"
            s = _randn(gen, (D,), dtype, dev, 0.1)
            dx, ds = ops.rmsnorm_bwd(x, s, dy)
            want_dx, want_ds = rmsnorm_bwd_ref(x, s, dy)
            e = _compare(f"rmsnorm bwd dx {label}", dx, want_dx, dtype)
            _compare_bwd(f"rmsnorm bwd dscale {label}", ds, want_ds, dtype)
            if dtype == torch.bfloat16 and (T, D) == (2048, 4096):
                err = e
            dx2, ds2 = ops.rmsnorm_bwd(x, s, dy)
            assert torch.equal(dx, dx2) and torch.equal(ds, ds2), f"rmsnorm bwd {label}: not deterministic"
    log("[kernels] rmsnorm bwd: run to run identical in every case")
    T, D, dtype = 2048, 4096, torch.bfloat16
    sets = [(_randn(gen, (T, D), dtype, dev), _randn(gen, (D,), dtype, dev, 0.1),
             _randn(gen, (T, D), dtype, dev)) for _ in range(4)]
    ms = time_ms(ops.rmsnorm_bwd, sets)
    plain = time_ms(rmsnorm_bwd_ref, sets)
    x, s, dy = (t.detach() for t in sets[0])
    xl = x.clone().requires_grad_()
    wl = (1.0 + s.float()).to(dtype).requires_grad_()
    y = torch.nn.functional.rms_norm(xl, (D,), wl, 1e-6)
    lib = profiled_calls(lambda: torch.autograd.grad(y, (xl, wl), dy, retain_graph=True))["device_ms"]
    bound, by = _bound(3 * T * D * 2 + 2 * D * 2, 8 * T * D, dtype)
    log(f"[kernels] rmsnorm bwd x ({T}, {D}) bf16: kernel {ms:.4f} ms, F.rms_norm backward {lib:.4f} ms "
        f"(kernel / library {ms / lib:.2f}), plain {plain:.4f} ms, bound {bound:.4f} ms ({by}, "
        f"{bound / ms:.1%} of it)")
    return dict(
        name="rmsnorm_bwd", route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/models/layers.py:22 (no Pallas kernel: JAX differentiates the jnp rmsnorm)",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib,
        shape=f"x, dy ({T}, {D}) bf16",
    )


def _ssd_bwd_args(gen, dev, dtype, b, L, H, G, cs, dt_shift=-1.0):
    """``_ssd_chunk_args`` of a (b, L) batch (mamba2's P = 64, N = 128), and
    float32 cotangents of y (the permuted view of the model's (b, nc, cs,
    H, P) order that autograd hands the backward) and of the state."""
    P, N = 64, 128
    x = _randn(gen, (b, L, H, P), dtype, dev)
    Bm, Cm = (_randn(gen, (b, L, G, N), dtype, dev) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn((b, L, H), generator=gen, device=dev) + dt_shift)
    A = -torch.exp(torch.randn((H,), generator=gen, device=dev) * 0.2)
    nc = L // cs
    dy = torch.randn((b, nc, cs, H, P), generator=gen, device=dev).permute(0, 3, 1, 2, 4)
    dS = torch.randn((b, H, nc, N, P), generator=gen, device=dev)
    return _ssd_chunk_args(x, dt, A, Bm, Cm, cs), dy, dS


def check_ssd_bwd(dev) -> dict:
    """The ssd backward kernel against ``ssd_chunk_bwd_ref`` on the card:
    cs 256 / 100 / 1, one group and one group per head, a strong decay (the
    span of cum inside a chunk past 88, where exp of the masked triangle
    overflows: every gradient finite), bf16 (the tensor-core route, each
    output's worst share of its limit logged) and fp32 (SIMT), run to run
    identical; an unaligned bf16 input raises; autograd through the scan on
    a ragged L (777: a padded 9-row tail) with an initial state against the
    plain scan's autograd; times at the train path's shape (one microbatch
    of mamba2-130m's (8, 2048) batch in 2), its kernels apart."""
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import ssd_chunk_bwd_ref

    gen = torch.Generator(device=dev).manual_seed(15)
    err = 0.0
    share = {}  # bf16: each output's worst (|kernel - plain| / limit) over the cases
    cases = ((512, 256, 24, 1, -1.0), (512, 256, 8, 8, -1.0), (300, 100, 24, 1, -1.0),
             (300, 100, 4, 4, -1.0), (5, 1, 4, 1, -1.0), (512, 256, 4, 1, 3.0))
    for L, cs, H, G, shift in cases:
        for dtype in (torch.bfloat16, torch.float32):
            args, dy, dS = _ssd_bwd_args(gen, dev, dtype, 1, L, H, G, cs, shift)
            label = f"{dtype} L={L} cs={cs} H={H} G={G} dt_shift={shift}"
            if shift > 0:
                span = float((args[2][..., 0] - args[2][..., -1]).max())
                log(f"[kernels] ssd bwd strong decay: cum spans {span:.1f} inside a chunk")
                assert span > 88, span
            got = ops.ssd_intra_chunk_bwd(*args, dy, dS)
            want = ssd_chunk_bwd_ref(*args, dy, dS)
            for name, g, w in zip(("dx", "ddt", "dcum", "dB", "dC"), got, want):
                _compare_bwd(f"ssd bwd {name} {label}", g, w, dtype)
                if dtype == torch.bfloat16:
                    w = w.float()
                    atol, rtol = BWD_TOL[dtype]
                    lim = atol * w.abs().max() + rtol * w.abs()
                    r = float(((g.float() - w).abs() / lim.clamp_min(1e-30)).max())
                    share[name] = max(share.get(name, 0.0), r)
            if cs == 1:
                assert bool((got[2] == 0).all()), f"ssd bwd {label}: dcum does not cancel to 0"
            again = ops.ssd_intra_chunk_bwd(*args, dy, dS)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), f"ssd bwd {label}: not deterministic"
    log("[kernels] ssd bwd: run to run identical in every case; dcum exactly 0 at cs 1")
    log("[kernels] ssd bwd bf16 (tensor cores): worst share of the limit over the cases: "
        + ", ".join(f"{k} {v:.4f}" for k, v in share.items()))
    # an unaligned bf16 input (x one element into its buffer) raises, nothing launched
    (x, *rest), dy, dS = _ssd_bwd_args(gen, dev, torch.bfloat16, 1, 512, 4, 1, 256)
    shifted = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view(x.shape)
    before = ops.bwd_launches.count
    try:
        ops.ssd_intra_chunk_bwd(shifted, *rest, dy, dS)
    except ValueError as exc:
        log(f"[kernels] ssd bwd unaligned bf16 x raised: {str(exc)[:100]}")
    else:
        raise AssertionError("ssd bwd: an unaligned bf16 x did not raise")
    assert ops.bwd_launches.count == before
    # autograd through the scan: ragged L, one group read in place, an initial state
    L, H, P, N = 777, 24, 64, 128
    leaves = [torch.randn((1, L, H, P), generator=gen, device=dev),
              torch.nn.functional.softplus(torch.randn((1, L, H), generator=gen, device=dev) - 1),
              -torch.exp(torch.randn((H,), generator=gen, device=dev) * 0.2),
              torch.randn((1, L, 1, N), generator=gen, device=dev), torch.randn((1, L, 1, N), generator=gen, device=dev),
              torch.randn((1, H, N, P), generator=gen, device=dev)]
    dy, ds = torch.randn((1, L, H, P), generator=gen, device=dev), torch.randn((1, H, N, P), generator=gen, device=dev)
    grads = []
    for scan in (ops.ssd_chunked, ops.ssd_chunked_ref):
        ts = [t.clone().requires_grad_() for t in leaves]
        y, s = scan(*ts[:5], 256, ts[5])
        grads.append(torch.autograd.grad((y * dy).sum() + (s * ds).sum(), ts))
    for name, g, w in zip(("x", "dt", "A", "B", "C", "initial state"), *grads):
        _compare_bwd(f"ssd_chunked grad {name} fp32 L={L} (kernels vs plain autograd)", g, w, torch.float32)
    # the train path's shape: x (4, 2048, 24, 64), B/C (4, 2048, 1, 128) bf16, cs 256
    b, L, H, G, cs, P, N, dtype = 4, 2048, 24, 1, 256, 64, 128, torch.bfloat16
    sets = [_ssd_bwd_args(gen, dev, dtype, b, L, H, G, cs) for _ in range(2)]
    sets = [(*args, dy, dS) for args, dy, dS in sets]
    got, want = ops.ssd_intra_chunk_bwd(*sets[0]), ssd_chunk_bwd_ref(*sets[0])
    for name, g, w in zip(("dx", "ddt", "dcum", "dB", "dC"), got, want):
        e = _compare_bwd(f"ssd bwd {name} at the train shape", g, w, dtype)
        if name == "dx":
            err = e
    del got, want
    ms = time_ms(ops.ssd_intra_chunk_bwd, sets)
    plain = time_ms(ssd_chunk_bwd_ref, sets[:1], iters=3)
    nc = L // cs
    n_chunks = b * H * nc  # (chunk, head) pairs
    pairs = cs * (cs + 1) // 2
    # per (chunk, head): s (N), dW (P), dx (P), dC (N), dB (N) over the
    # causal pairs, and u = dS x, v = dS^T B over every row
    flops = n_chunks * (2 * pairs * (3 * N + 2 * P) + 4 * cs * N * P)
    el = 2  # bf16
    bytes_moved = (b * L * H * P * el + 2 * b * L * G * N * el  # x, B, C
                   + b * L * H * P * 4 + n_chunks * N * P * 4 + 2 * b * L * H * 4  # dy, dS, dt, cum
                   + b * L * H * P * el + 2 * b * L * H * 4 + 2 * b * L * G * N * el)  # dx, ddt, dcum, dB, dC
    bound, by = _bound(bytes_moved, flops, dtype)
    t_simt = flops / PEAK_FLOPS[torch.float32] * 1e3
    log(f"[kernels] ssd bwd bound: {flops / 1e9:.3f} GFLOP at the bf16 tensor rate "
        f"{flops / PEAK_FLOPS[dtype] * 1e3:.5f} ms, {bytes_moved} bytes {bytes_moved / HBM_BYTES_PER_S * 1e3:.5f} ms: "
        f"bound {bound:.5f} ms ({by}), kernel at {bound / ms:.1%} of it; at the f32 SIMT rate the "
        f"products take {t_simt:.5f} ms, kernel at {t_simt / ms:.1%} of that")
    parts = dict(profiled_calls(lambda: ops.ssd_intra_chunk_bwd(*sets[0]))["top"])
    log("[kernels] ssd bwd kernels apart (profiler, 10 calls): "
        + ", ".join(f"{n[:70]} {t:.4f} ms" for n, t in parts.items()))
    main_ms = sum(t for n, t in parts.items() if "wgmma" in n)
    cvt_ms = sum(t for n, t in parts.items() if "cvt" in n)
    dcum_ms = sum(t for n, t in parts.items() if "dcum" in n)
    cvt_bytes = b * L * H * P * (4 + 2) + n_chunks * N * P * (4 + 2)
    log(f"[kernels] ssd bwd apart: wgmma kernel {main_ms:.4f} ms ({flops / main_ms / 1e9:.1f} TFLOP/s of "
        f"the needed work), dy / dS conversion {cvt_ms:.4f} ms ({cvt_bytes} bytes, "
        f"{cvt_bytes / cvt_ms / 1e9:.3f} TB/s), dcum pass {dcum_ms:.4f} ms")
    return dict(
        name="ssd_bwd", route="cuda", source="src/repro_torch/kernels/csrc/ssd_bwd_wgmma.cu",
        replaces="src/repro/models/ssm.py:74 (no Pallas kernel: JAX differentiates the jnp ssd_chunked)",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=None,
        simt_ms=t_simt, flops=flops, bytes=bytes_moved,
        shape=f"x ({b}, {L}, {H}, {P}), B/C ({b}, {L}, {G}, {N}) bf16, cs {cs}; {flops / 1e9:.2f} GFLOP",
    )


def _sub_shapes(record: dict) -> dict:
    """A kernel record's other timed shapes (the Dh 256, MLA, ring, ...
    paths), each a dict with its own ``shape`` and times."""
    return {k: v for k, v in record.items() if isinstance(v, dict) and "ms" in v and "shape" in v}


def kernel_phase(dev) -> list[dict]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check_hgmma()
    resource_usage()
    records = [check_rmsnorm(dev), check_flash(dev), check_decode(dev), check_ssd(dev),
               check_flash_bwd(dev), check_rmsnorm_bwd(dev), check_ssd_bwd(dev)]
    for r in records:
        for t in (r, *_sub_shapes(r).values()):
            lib = "none (no single PyTorch call)" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
            log(
                f"[kernels] {r['name']} at {t['shape']}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, library {lib}, bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']})"
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
    before = {name: ops[name].count for name in cases}
    outs = {name: SpData(None) for name in cases}
    with SpRuntime(workers=SpWorkerTeam(["cuda"])) as rt:
        for name, (codelet, args, static) in cases.items():
            codelet(*(SpData(a) for a in args), outs[name], **static)
        rt.wait_all_tasks()
    torch.cuda.synchronize()
    moved = {name: ops[name].count - before[name] for name in cases}
    log(f"[codelets] one codelet per kernel on a 'cuda' worker: launches {moved}")
    assert moved == {name: 1 for name in cases}, moved
    for name, out in outs.items():
        first = out.value[0] if isinstance(out.value, tuple) else out.value
        assert torch.isfinite(first.float()).all(), name


def examples_phase(dev) -> dict:
    """The five examples of ``repro_torch.examples`` on the card, at small
    step counts, with their own asserts: the quickstart's ``double`` ran
    its ``cuda`` variant; the heterogeneous GEMM ran at least one task on
    the card worker and is within 1e-3 of A @ B; the Monte-Carlo chain's
    speculative and plain runs agree; train_lm's loss falls; serve_lm's
    fitted model continues the rule and its speculative streams equal the
    plain engine's.  Graphs and checkpoints go to a temporary directory."""
    import tempfile

    from repro_torch.examples import (
        heterogeneous_gemm,
        quickstart,
        serve_lm,
        speculative_monte_carlo,
        train_lm,
    )

    out = {}
    with tempfile.TemporaryDirectory(prefix="smoke-examples-") as d:
        t0 = time.perf_counter()
        q = quickstart.main(["--out-dir", d])
        assert q["double_ran"] == "cuda" and q["double"] == 42.0 and q["acc"] == 28.0, q
        g = heterogeneous_gemm.main(["--out-dir", d])
        assert g["by_kind"].get("cuda", 0) >= 1 and g["max_err"] < 1e-3, g
        mc = speculative_monte_carlo.main(["--steps", "12", "--accept-p", "0.0", "0.5"])
        t = train_lm.main(["--steps", "20", "--seq", "128", "--ckpt-dir", d, "--ckpt-every", "10"])
        assert t["last"] < t["first"] and t["saved"] == [10, 20], t
        sv = serve_lm.main(["--draft", "4"])
        out = dict(gemm_by_kind=g["by_kind"], gemm_err=g["max_err"], mc=[(r["state"], r["obs"]) for r in mc],
                   train_loss=(t["first"], t["last"]), serve_accuracy=sv["accuracy"],
                   spec_accept=sv["accept_rate"], seconds=time.perf_counter() - t0)
    torch.cuda.synchronize()
    log(f"[examples] all five ran on the card in {out['seconds']:.1f} s: quickstart double on 'cuda'; gemm "
        f"tasks by worker kind {out['gemm_by_kind']}, max err {out['gemm_err']:.2e}; monte carlo (state, obs) "
        f"{out['mc']}; train_lm loss {out['train_loss'][0]:.4f} -> {out['train_loss'][1]:.4f}; serve_lm "
        f"accuracy {out['serve_accuracy']:.2%}, speculative accept rate {out['spec_accept']:.2f}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 5-6. serving at full width
# ---------------------------------------------------------------------------

def _kernel_ops() -> dict:
    """Each kernel's launch counter, by the name its record carries."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    return {"rmsnorm": rmsnorm_ops.launches, "flash_attention": flash_ops.launches,
            "decode_attention": decode_ops.launches, "ssd": ssd_ops.launches,
            "flash_attention_bwd": flash_ops.bwd_launches, "rmsnorm_bwd": rmsnorm_ops.bwd_launches,
            "ssd_bwd": ssd_ops.bwd_launches}


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


# device-time categories by kernel name, first match wins
KINDS = (("flash backward", ("flash_bwd",)), ("flash forward", ("flash_fwd",)), ("ssd backward", ("ssd_bwd",)),
         ("rmsnorm", ("rmsnorm", "dscale_reduce")), ("decode / ssd", ("decode_kernel", "ssd_chunk")),
         ("matrix products (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "splitK")),
         ("reductions", ("reduce_kernel", "scan")), ("copies", ("copy", "Copy", "cat", "Cat")))


def _device_rows(prof, prof_wall_ms: float, n_iter: int) -> dict:
    """Device time per iteration by kernel name and by kind (``KINDS``;
    the rest is elementwise), and the busy share of the profiled wall
    time."""
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0.0)
        if t and ev.device_type.name == "CUDA":
            rows.append((ev.key, t / 1e3 / n_iter))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(ms for _, ms in rows)
    kinds: dict = {}
    for name, ms in rows:
        kind = next((k for k, pats in KINDS if any(pt in name for pt in pats)), "elementwise and other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    return dict(profiled_wall_ms=prof_wall_ms, device_ms=device_ms,
                busy=device_ms / prof_wall_ms if prof_wall_ms else 0.0,
                top=[(name[:90], ms) for name, ms in rows[:12]],
                kinds=sorted(kinds.items(), key=lambda r: -r[1]))


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


def serving_phase(dev, arch: str = "deepseek-7b", tag: str = "serve", n_layers: int | None = None) -> dict:
    """Full-width ``arch`` (seeded random bf16 weights made on the card;
    ``n_layers`` cuts the depth) through ``ServeEngine``: 4 slots,
    ``MAX_SEQ``; the ragged prompts and a sampled one, then duplicates
    (prefix share, restore); exact launch counts; one greedy stream
    against the sequential loop; a profiled decode iteration and 2048-token
    prefill; peak memory.  Dense (deepseek-7b, gemma-7b), MLA
    (minicpm3-4b: the latent rows are paged) and MoE (qwen3-moe)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine

    gc.collect()  # earlier phases' models and engines are cyclic garbage
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    t0 = time.perf_counter()
    model = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    cut = f" of {get_config(arch).n_layers}" if n_layers is not None else ""
    heads = (f"MLA: {cfg.n_heads} heads, q / k {cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim}, v "
             f"{cfg.mla.v_head_dim}, latent {cfg.mla.kv_lora_rank} + rope {cfg.mla.qk_rope_head_dim}"
             if cfg.mla else f"{cfg.n_heads} heads of {cfg.head_dim}, {cfg.n_kv_heads} KV heads")
    moe = (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k} of {cfg.moe.d_ff_expert}, {cfg.moe.dispatch} "
           "dispatch" if cfg.moe else "")
    log(f"[{tag}] {arch} ({cfg.n_layers}{cut} layers, d_model {cfg.d_model}, {heads}{moe}, "
        f"{n_params / 1e9:.3f} B params, {cfg.dtype}) initialised on the card in {time.perf_counter() - t0:.1f} s")
    if cfg.moe:
        from repro_torch.models.moe import capacity

        C = capacity(N_SLOTS, cfg)
        log(f"[{tag}] decode routes {N_SLOTS} tokens a step with capacity C = {C} >= {N_SLOTS} slots: an "
            "expert takes each token at most once, so none overflows and a slot's tokens do not depend on "
            "the others' (the sequential-loop check holds)")
        assert C >= N_SLOTS

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
        log(f"[{tag}] warm-up wave ({len(warm)} requests, 2 tokens each) took {time.perf_counter() - t0:.2f} s")
        base = (eng.prefills, eng.decode_steps, eng.restores)
        # ---- the main path: counts from 0 just before, read just after ----
        for c in ops.values():
            c.reset()
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
        launches = {name: c.count for name, c in ops.items()}
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
    want = _serve_launches(cfg, prefills=stats["prefills"], decode_steps=stats["decode_steps"])
    per = _layer_launches(cfg)
    log(f"[{tag}] launches on the main path {launches}; expected {want} from "
        f"{stats['prefills']} prefills and {stats['decode_steps']} decode steps (a prefill: {per['flash']} "
        f"flash; a decode step: {per['decode']} decode attention; a forward: {per['norms']} rmsnorm)")
    assert launches == want, "the main path did not run through every kernel as expected"
    assert launches["flash_attention"] > 0 and launches["rmsnorm"] > 0
    assert launches["decode_attention"] > 0 or cfg.mla is not None  # MLA decodes with torch ops

    n_tok = sum(len(r.out_tokens) for r in reqs)
    log(f"[{tag}] {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tok/s, "
        f"first token included), {stats['steps']} engine iterations, {stats['prefills']} prefills, "
        f"{stats['restores']} restores, peak device memory {peak / 2**30:.2f} GiB ({peak} bytes)")
    for r in reqs:
        log(f"[{tag}]   prompt {len(r.prompt):5d} temp {r.temperature}: TTFT "
            f"{(r.t_first - r.t_arrival) * 1e3:.1f} ms, tokens {r.out_tokens[:8]}...")
    log(f"[{tag}] duplicate (prefix-shared, re-prefilled) stream equals the original's: "
        f"{dup.out_tokens == greedy[0].out_tokens}; restored request's first tokens {dup_restore.out_tokens[:8]}")

    want_toks = _sequential_greedy(model, cfg, prompts[1], 1, dev)[0]
    log(f"[{tag}] sequential prefill + decode_step loop for prompt {PROMPT_LENS[1]}: {want_toks}")
    assert greedy[1].out_tokens == want_toks, (greedy[1].out_tokens, want_toks)
    log(f"[{tag}] engine stream equals the sequential loop")
    sp = step_profile
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    sp["weights_bound_ms"] = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[profile] {arch} decode iteration with {N_SLOTS} busy slots: {sp['wall_ms']:.2f} ms wall "
        f"({N_SLOTS / sp['wall_ms'] * 1e3:.1f} tok/s); under the profiler {sp['profiled_wall_ms']:.2f} ms "
        f"wall, {sp['device_ms']:.2f} ms device time, device busy {sp['busy']:.1%}; reading the "
        f"{weight_bytes / 1e9:.2f} GB of weights once takes {sp['weights_bound_ms']:.2f} ms")
    for name, ms in sp["top"]:
        log(f"[profile]   {ms:8.4f} ms  {name}")
    pp = prefill_profile
    log(f"[profile] {arch} prefill of {PROMPT_LENS[0]} tokens alone: {pp['wall_ms']:.2f} ms wall "
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


def recurrent_serving_phase(dev, arch: str = "mamba2-130m", tag: str = "mamba2") -> dict:
    """Full-width mamba2-130m or recurrentgemma-9b through ``ServeEngine``,
    8 slots of ``M_MAX_SEQ``.  mamba2: the prefill runs the ssd kernel
    once per layer and rmsnorm once per layer plus the final norm; decode
    is plain torch besides rmsnorm.  recurrentgemma: its 12 local-attention
    layers run flash attention a prefill and decode attention a step on a
    ring of the 2048-token window (the 4096-token prompt wraps both), its
    26 rec layers torch ops, and every forward 77 norms.  Neither cache is
    pageable, so the duplicate prompt re-prefills.  A request admitted
    beside 7 decoding ones is held against prefill (its installed caches)
    and against the sequential loop (tokens, last logits, caches)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.runtime.serve import prime_cache
    from repro_torch.serving import ServeEngine

    cfg = get_config(arch)
    gc.collect()  # the earlier phases' engines and models are cyclic garbage
    torch.cuda.empty_cache()
    mem_base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    what = (f"d_state {cfg.ssm.d_state}" if cfg.ssm else
            f"(rec, rec, attn) x {cfg.n_layers // 3} + 2 rec, lru width {cfg.hybrid.lru_width}, {cfg.n_heads} heads "
            f"of {cfg.head_dim} on {cfg.n_kv_heads} KV head, window {cfg.hybrid.window}")
    log(f"[{tag}] {arch} ({cfg.n_layers} layers, d_model {cfg.d_model}, {what}, {n_params / 1e9:.3f} B params, "
        f"{cfg.dtype}) initialised on the card in {time.perf_counter() - t0:.1f} s ({mem_base} bytes "
        "allocated before it)")

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
        log(f"[{tag}] warm-up wave ({len(warm)} requests, 2 tokens each) took {time.perf_counter() - t0:.2f} s")
        base = (eng.prefills, eng.decode_steps, eng.restores)
        # ---- the main path: counts from 0 just before, read just after ----
        for c in ops.values():
            c.reset()
        t0 = time.perf_counter()
        greedy = [eng.submit(p, M_GEN) for p in prompts]
        sampled = eng.submit(sampled_prompt, M_GEN, temperature=0.8, top_k=40, seed=7)
        eng.run_until_drained()
        dup = eng.submit(prompts[1], M_GEN)
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: c.count for name, c in ops.items()}
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
    want = _serve_launches(cfg, prefills=stats["prefills"], decode_steps=stats["decode_steps"])
    per = _layer_launches(cfg)
    log(f"[{tag}] launches on the main path {launches}; expected {want} from "
        f"{stats['prefills']} prefills and {stats['decode_steps']} decode steps (a prefill: {per['flash']} "
        f"flash, {per['ssd']} ssd; a decode step: {per['decode']} decode attention; a forward: {per['norms']} "
        "rmsnorm)")
    assert launches == want, "the main path did not run through every kernel as expected"
    assert launches["rmsnorm"] > 0 and all(launches[k] > 0 for k, n in want.items() if n)

    n_tok = sum(len(r.out_tokens) for r in reqs)
    log(f"[{tag}] {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tok/s, "
        f"first token included), {stats['steps']} engine iterations, {stats['prefills']} prefills, "
        f"{stats['restores']} restores, peak device memory {peak / 2**30:.2f} GiB ({peak} bytes)")
    for r in reqs:
        log(f"[{tag}]   prompt {len(r.prompt):5d} temp {r.temperature}: TTFT "
            f"{(r.t_first - r.t_arrival) * 1e3:.1f} ms, tokens {r.out_tokens[:8]}...")
    log(f"[{tag}] duplicate (re-prefilled) stream equals the original's: "
        f"{dup.out_tokens == greedy[1].out_tokens}")
    assert dup.out_tokens == greedy[1].out_tokens

    # greedy streams repeat one token under this seeded init, so the slot's
    # caches and logits carry the check: a stale or mixed slot differs there
    from repro_torch.models import prefill

    _, pre = prefill(model, {"tokens": torch.from_numpy(prompts[2][None, :]).to(dev)}, cfg)
    pre = prime_cache(cfg, pre, len(prompts[2]), M_MAX_SEQ)  # ssm / rec leaves pass; k / v into the ring
    for k in pre:
        _compare_ssd(f"{tag} slot {run['slot']} {k} installed by the engine vs prefill", run["installed"][k],
                     pre[k][:, 0])
    want_toks, want_logits, want_caches = _sequential_greedy(
        model, cfg, prompts[2], run["slot"], dev, M_SLOTS, M_MAX_SEQ, M_GEN
    )
    log(f"[{tag}] sequential prefill + decode_step loop for prompt {M_PROMPT_LENS[2]}: {want_toks[:8]}...")
    assert greedy[2].out_tokens == want_toks, (greedy[2].out_tokens, want_toks)
    assert run["req"].out_tokens == want_toks, (run["req"].out_tokens, want_toks)
    V = cfg.vocab
    _compare(f"{tag} last decode logits, engine vs sequential loop", run["logits"][:V], want_logits[:V],
             torch.bfloat16)
    for k in want_caches:
        _compare_ssd(f"{tag} slot {k} after the last decode step, engine vs sequential loop",
                     run["caches"][k], want_caches[k])
    log(f"[{tag}] engine stream, last logits and slot caches equal the sequential loop's")
    sp = step_profile
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    sp["weights_bound_ms"] = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[profile] {arch} decode iteration with {M_SLOTS} busy slots: {sp['wall_ms']:.2f} ms wall "
        f"({M_SLOTS / sp['wall_ms'] * 1e3:.1f} tok/s); under the profiler {sp['profiled_wall_ms']:.2f} ms "
        f"wall, {sp['device_ms']:.2f} ms device time, device busy {sp['busy']:.1%}; reading the "
        f"{weight_bytes / 1e9:.3f} GB of weights once takes {sp['weights_bound_ms']:.4f} ms")
    for name, ms in sp["top"]:
        log(f"[profile]   {ms:8.4f} ms  {name}")
    pp = prefill_profile
    log(f"[profile] {arch} prefill of {M_PROMPT_LENS[0]} tokens alone: {pp['wall_ms']:.2f} ms wall "
        f"(median of 3); under the profiler {pp['profiled_wall_ms']:.2f} ms wall, "
        f"{pp['device_ms']:.2f} ms device time, device busy {pp['busy']:.1%}")
    mixer = "ssd_chunk" if cfg.ssm else "flash_fwd"
    mixer_ms = sum(ms for name, ms in pp["top"] if mixer in name)
    log(f"[profile] the {mixer} kernel takes {mixer_ms:.3f} ms of that prefill's {pp['device_ms']:.2f} ms of "
        f"device time ({mixer_ms / pp['device_ms']:.1%})")
    for name, ms in pp["top"]:
        log(f"[profile]   {ms:8.4f} ms  {name}")
    return dict(
        launches=launches, tok_per_s=n_tok / wall, wall_s=wall, peak_bytes=peak, stats=stats,
        ttft_ms=[(r.t_first - r.t_arrival) * 1e3 for r in reqs], decode_profile=sp,
        prefill_profile=pp,
    )


# ---------------------------------------------------------------------------
# 7. whole model: card against CPU
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


# ---------------------------------------------------------------------------
# 8-10. the train step
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB, TRAIN_STEPS = 2, 2048, 2, 4


def _train_launches_per_step(cfg, n_mb: int) -> dict:
    """Kernel launches of one train step: per microbatch, each layer's
    mixer (flash attention for an attention or MLA layer, the ssd
    intra-chunk step for an ssm layer; none for a rec layer) and norms
    (``_layer_launches``) plus the final norm forward, the layers' kernels
    once more when ``remat="full"`` recomputes them
    (``torch.utils.checkpoint`` reruns the layer's forward, the autograd
    functions' forwards included), and one backward of each."""
    remat = 2 if cfg.remat == "full" else 1
    c = _layer_launches(cfg)
    return {
        "flash_attention": n_mb * remat * c["flash"],
        "flash_attention_bwd": n_mb * c["flash"],
        "ssd": n_mb * remat * c["ssd"],
        "ssd_bwd": n_mb * c["ssd"],
        "rmsnorm": n_mb * (remat * (c["norms"] - 1) + 1),
        "rmsnorm_bwd": n_mb * c["norms"],
        "decode_attention": 0,
    }


def _batches(cfg, dev, n: int, batch: int, seq: int) -> list[dict]:
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models.config import ShapeSpec

    ds = SyntheticLMDataset(cfg, ShapeSpec("train", "train", seq, batch), seed=0)
    return [{k: torch.from_numpy(v).to(dev) for k, v in ds.batch_for_step(i).items()} for i in range(n)]


def _step_grads(model, cfg, batch: dict, n_mb: int) -> tuple[dict, float]:
    """The train step's gradients, unstaged: ``loss_fn`` and
    ``torch.autograd.grad`` on each of ``n_mb`` microbatches, added in
    float32 and divided by ``n_mb``, as ``runtime/train.py``'s microbatch
    and finalize codelets do.  → (gradients, mean loss)."""
    from repro_torch.models import loss_fn

    names, tensors = zip(*model.named_parameters())
    acc = {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device) for n, t in zip(names, tensors)}
    mbs = {k: v.reshape((n_mb, v.shape[0] // n_mb) + tuple(v.shape[1:])) for k, v in batch.items()}
    loss_sum = 0.0
    for i in range(n_mb):
        with torch.enable_grad():
            loss, _ = loss_fn(model, {k: v[i] for k, v in mbs.items()}, cfg)
            g = torch.autograd.grad(loss, tensors)
        with torch.no_grad():
            for n, t in zip(names, g):
                acc[n].add_(t)
        loss_sum += float(loss.detach())
        del g
    for t in acc.values():
        t.div_(n_mb)
    return acc, loss_sum / n_mb


def _apply_update(state, grads: dict, update, lr: float):
    """``make_optimizer``'s ``update`` on ``state`` from ``grads``, with the
    optimizer codelet's clip (global norm 1.0) and nonfinite check."""
    from repro_torch.optim import TrainState, global_norm

    gnorm = global_norm(grads.values())
    scale = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=gnorm.device)
    update(grads, state.opt, dict(state.params.named_parameters()), lr_t, state.step,
           accept=torch.isfinite(gnorm), grad_scale=scale)
    return TrainState(step=state.step + 1, params=state.params, opt=state.opt)


def _moe_parity_step(cpu, gpu, cfg, batch: dict, n_mb: int, update, lr: float, tag: str):
    """One step of a MoE model on both devices: each computes its gradients
    (``_step_grads``), the card's are held elementwise against the CPU's
    (each within 1e-4 of its leaf's largest magnitude, as
    ``tests/test_torch_train.py`` holds the port's against ``repro``'s),
    then both optimizers update from the CPU's.  → (cpu, gpu, card
    metrics, CPU metrics)."""
    from repro_torch.optim import global_norm

    dev = next(gpu.params.parameters()).device
    grads_c, loss_c = _step_grads(cpu.params, cfg, {k: v.cpu() for k, v in batch.items()}, n_mb)
    grads_g, loss_g = _step_grads(gpu.params, cfg, batch, n_mb)
    worst, at = -1.0, None
    for n, t in grads_g.items():
        w = grads_c[n].to(dev)
        share = float((t - w).abs().max() / (1e-4 * w.abs().max() + 1e-12))
        if share > worst:
            worst, at = share, n
    mg = dict(loss=loss_g, grad_norm=float(global_norm(grads_g.values())))
    mc = dict(loss=loss_c, grad_norm=float(global_norm(grads_c.values())))
    del grads_g, w
    cpu = _apply_update(cpu, grads_c, update, lr)
    gpu = _apply_update(gpu, {n: t.to(dev) for n, t in grads_c.items()}, update, lr)
    log(f"[{tag}] step {int(gpu.step)}: the card's gradients within {worst:.3f} of the limit 1e-4·max|leaf| "
        f"(worst {at}); both optimizers updated from the CPU's gradients")
    assert worst <= 1.0, (worst, at)
    return cpu, gpu, mg, mc


def _parity_run(dev, cfg, *, tag: str, seq: int, steps: int = 2, n_mb: int = 2, lr: float = 3e-4) -> dict:
    """``steps`` staged train steps of ``cfg`` (batch 2 of ``seq`` tokens in
    ``n_mb`` microbatches) on the card (kernels) and on the CPU port (plain
    versions) from the same state.  Loss and grad norm within 1e-3 relative
    at each step; after the last step every parameter within 2·steps·lr
    for adamw (its update m / (sqrt(v) + eps) does not scale with the
    gradient, so an element whose gradient is float noise may move by up to
    lr differently on the two devices) and within 1e-6 for adafactor (its
    update is normalised by row and column statistics); exact launch
    counts per step.

    A MoE model's parity is held in two parts (``_moe_parity_step``, the
    train step's arithmetic unstaged): the card's gradients elementwise
    against the CPU's at every step, and the parameters after the card's
    optimizer (``make_optimizer``'s update) has updated them from the CPU's
    gradients.  Each expert's gradient comes from a few tokens, and some of
    its elements are float noise, whose sign then differs between the
    devices; Adafactor's update g / sqrt(v) does not scale with the
    gradient and moves such elements by O(lr) (on an H100, two steps put
    one expert weight 1.9 times its own CPU move away from the CPU's)."""
    from repro_torch.models import Transformer, leaf_layout, set_trainable
    from repro_torch.optim import TrainState, make_optimizer
    from repro_torch.runtime.train import build_train_step, init_train_state

    t_start = time.perf_counter()
    ops = _kernel_ops()
    gpu = init_train_state(cfg, 3, device=dev)
    model = set_trainable(Transformer(cfg, device="cpu"))
    with torch.no_grad():
        model.load_state_dict(gpu.params.state_dict())
    copy = lambda t: {k: copy(v) for k, v in t.items()} if isinstance(t, dict) else t.to("cpu", copy=True)  # noqa: E731
    cpu = TrainState(step=gpu.step.cpu(), params=model, opt=copy(gpu.opt))
    batches = _batches(cfg, dev, steps, 2, seq)
    art_g, art_c = build_train_step(cfg, n_microbatches=n_mb), build_train_step(cfg, n_microbatches=n_mb)
    _, update = make_optimizer(cfg.optimizer, cfg.opt_state_dtype, leaf_layout(cfg))
    want_launches = {k: v * steps for k, v in _train_launches_per_step(cfg, n_mb).items()}
    for c in ops.values():
        c.reset()
    worst = 0.0
    for b in batches:
        if cfg.moe is not None:
            cpu, gpu, mg, mc = _moe_parity_step(cpu, gpu, cfg, b, n_mb, update, lr, tag)
        else:
            cpu, mc = art_c(cpu, {k: v.cpu() for k, v in b.items()})
            gpu, mg = art_g(gpu, b)
        for key in ("loss", "grad_norm"):
            g, c = float(mg[key]), float(mc[key])
            assert np.isfinite(g), (cfg.optimizer, key, g)
            worst = max(worst, abs(g - c) / abs(c))
            log(f"[{tag}] {cfg.optimizer} step {int(gpu.step)} {key}: card {g:.7f} cpu {c:.7f}")
    launches = {name: c.count for name, c in ops.items()}
    assert launches == want_launches, (cfg.optimizer, launches, want_launches)
    cpu_params = dict(cpu.params.named_parameters())
    dp, dp_at = max((float((p.detach().cpu() - cpu_params[n].detach()).abs().max()), n)
                    for n, p in gpu.params.named_parameters())
    limit = 2 * steps * lr if cfg.optimizer == "adamw" else 1e-6
    log(f"[{tag}] {cfg.name} {cfg.optimizer}: {cfg.n_layers}-layer full-width fp32, {steps} steps of "
        f"{n_mb} microbatches of {seq} tokens: max relative loss / grad-norm error {worst:.3e} (limit "
        f"1e-3), max parameter difference {dp:.3e} at {dp_at} (limit {limit:.1e}); launches {launches}; "
        f"{time.perf_counter() - t_start:.1f} s")
    assert worst <= 1e-3 and dp <= limit
    del gpu, cpu, model, art_g, art_c, batches
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rel_err=worst, param_diff=dp, launches=launches)


def train_parity_phase(dev) -> dict:
    """Full width, depth cut, float32, B = 2, two microbatches, two steps
    (``_parity_run``): deepseek-7b (2 layers, L = 256) with Adafactor and
    with AdamW, gemma-7b (2 layers, L = 128; head dim 256: the f32 routes
    of the flash forward and backward at Dh 256), minicpm3-4b (2 MLA
    layers, L = 256), recurrentgemma-9b (3 layers, L = 128) and
    qwen3-moe-235b-a22b (1 layer, L = 128) with Adafactor."""
    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    # the CPU side is most of this phase's time (gemma-7b's 256000-row tied
    # head takes ~100 s at 256 tokens a sequence, recurrentgemma-9b's and
    # qwen3-moe's are as slow): those three run at 128.  Depths:
    # minicpm3-4b 2 MLA layers, recurrentgemma-9b one (rec, rec, attn)
    # super-block, qwen3-moe one layer
    for arch, opt, seq, n_layers in (("deepseek-7b", "adafactor", 256, 2), ("deepseek-7b", "adamw", 256, 2),
                                     ("gemma-7b", "adafactor", 128, 2), ("minicpm3-4b", "adafactor", 256, 2),
                                     ("recurrentgemma-9b", "adafactor", 128, 3),
                                     ("qwen3-moe-235b-a22b", "adafactor", 128, 1)):
        cfg = get_config(arch).replace(n_layers=n_layers, dtype="float32", logits_chunk=seq, optimizer=opt)
        out[opt if arch == "deepseek-7b" else arch] = _parity_run(dev, cfg, tag="train-parity", seq=seq)
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _codelet_times(art, state, batch) -> tuple:
    """One train step with each codelet's body between two CUDA events on
    the stream it enqueues on: the device time of each task (the staged
    runtime runs the bodies in order on this thread, and the backward's
    kernels go to the same stream)."""
    from repro_torch.runtime import train as train_mod

    codelets = (train_mod._microbatch_codelet, train_mod._grad_finalize_codelet,
                train_mod._optimizer_codelet)
    spans, saved = [], [cl._impls["ref"] for cl in codelets]

    def timed(fn, name):
        def body(*args, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            spans.append((name, start, end))
            return out
        return body

    for cl, (fn, avail) in zip(codelets, saved):
        cl._impls["ref"] = (timed(fn, cl.name), avail)
    try:
        state, _ = art(state, batch)
    finally:
        for cl, impl in zip(codelets, saved):
            cl._impls["ref"] = impl
    torch.cuda.synchronize()
    return state, [(name, start.elapsed_time(end)) for name, start, end in spans]


def _profile_train_step(art, state, batch) -> tuple:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = art(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return state, m, _device_rows(prof, wall_ms, 1)


# the train runs: arch → (its layers here, the phase's tag, nonfinite rollback);
# full depth but for qwen3-moe (the fixed cut above)
TRAIN_RUNS = {"deepseek-7b": (30, "train", True), "gemma-7b": (28, "train-gemma", False),
              "minicpm3-4b": (62, "train-minicpm3", False),
              "recurrentgemma-9b": (38, "train-rgemma", False),
              "qwen3-moe-235b-a22b": (MOE_TRAIN_LAYERS, "train-moe", False)}
# timed steps a run: the other families' runs time 2 (the first is warm-up),
# to keep the script inside its time limit
TRAIN_STEPS_OF = {"minicpm3-4b": 3, "recurrentgemma-9b": 3, "qwen3-moe-235b-a22b": 3}


def train_phase(dev, arch: str = "deepseek-7b") -> dict:
    """``arch`` at full width (bf16) and the depth of ``TRAIN_RUNS``,
    Adafactor, ``remat="full"``, logits in chunks of 1024, a global batch of
    (2, 2048) in two microbatches: four steps (``TRAIN_STEPS_OF``: three) on
    ``SpRuntime(backend="staged")``.  Then each task's device time, one
    profiled step and (deepseek-7b) a nonfinite rollback on the card.
    Model FLOPs count 6·N·tokens over the parameters in matrix products
    (a MoE layer's experts at top_k / n_experts of theirs: the active
    parameters) plus attention's 3 × 2·H·(Dk + Dv) a unmasked pair."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.train import build_train_step, init_train_state

    n_layers, tag, rollback = TRAIN_RUNS[arch]
    n_steps = TRAIN_STEPS_OF.get(arch, TRAIN_STEPS)
    gc.collect()  # the serving phases' models and engines are cyclic garbage
    torch.cuda.empty_cache()
    mem_base = torch.cuda.memory_allocated()
    full = get_config(arch)
    cfg = full.replace(optimizer="adafactor", n_layers=n_layers)
    assert (cfg.remat, cfg.logits_chunk, cfg.dtype) == ("full", 1024, "bfloat16")
    t0 = time.perf_counter()
    state = init_train_state(cfg, 0, device=dev)
    torch.cuda.synchronize()
    params = dict(state.params.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    # parameters in matrix products: not the embedding gather, the norm
    # scales, biases, gates' diagonals nor the rec layers' conv taps, but a
    # tied embedding is also the logits product's matrix; a MoE layer's
    # experts count at top_k / n_experts (the active parameters)
    n_matmul = sum(p.numel() for n, p in params.items()
                   if p.dim() >= 2 and not n.endswith("conv_w")) - state.params.embedding.numel()
    if cfg.tie_embeddings:
        n_matmul += cfg.vocab * cfg.d_model
    if cfg.moe:
        experts = sum(p.numel() for n, p in params.items() if ".moe.w" in n)
        n_matmul -= experts * (1 - cfg.moe.top_k / cfg.moe.n_experts)
    cut = f" of {full.n_layers}" if n_layers != full.n_layers else ""
    log(f"[{tag}] {arch} ({cfg.n_layers}{cut} layers, {n_params / 1e9:.3f} B params, {n_matmul / 1e9:.3f} B "
        f"{'active ' if cfg.moe else ''}in matrix products, {cfg.dtype}, {cfg.optimizer}, remat {cfg.remat}, "
        f"logits chunk {cfg.logits_chunk}) initialised on the card in {time.perf_counter() - t0:.1f} s "
        f"({mem_base} bytes allocated before it)")
    art = build_train_step(cfg, n_microbatches=TRAIN_MB, schedule_policy="overlap")
    batches = _batches(cfg, dev, n_steps + 2, TRAIN_BATCH, TRAIN_SEQ)  # + timed / profiled and rollback steps
    ops = _kernel_ops()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts from 0 just before, read just after ----
    for c in ops.values():
        c.reset()
    walls, losses, gnorms = [], [], []
    for b in batches[:n_steps]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = art(state, b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    launches = {name: c.count for name, c in ops.items()}
    # ------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * n_steps for k, v in _train_launches_per_step(cfg, TRAIN_MB).items()}
    log(f"[{tag}] launches on the main path {launches}; expected {want} from {n_steps} steps of "
        f"{TRAIN_MB} microbatches")
    assert launches == want, "the train step did not run through every kernel as expected"
    assert all(np.isfinite(losses)) and all(np.isfinite(gnorms)), (losses, gnorms)
    assert int(state.step) == n_steps
    assert art.schedule_names == ["mb0", "mb1", "grad_allreduce", "optimizer"], art.schedule_names
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_ms = float(np.median(walls[1:]))
    dk, dv = ((cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim, cfg.mla.v_head_dim) if cfg.mla
              else (cfg.head_dim, cfg.head_dim))
    window = cfg.hybrid.window if cfg.hybrid else cfg.attn_window
    attn = (3 * 2 * cfg.n_heads * (dk + dv) * _pairs(TRAIN_SEQ, TRAIN_SEQ, True, window, 0) * TRAIN_BATCH
            * _layer_launches(cfg)["flash"])
    model_flops = 6 * n_matmul * tokens + attn
    tflops = model_flops / (step_ms / 1e3) / 1e12
    log(f"[{tag}] losses {losses}, grad norms {gnorms}; schedule {art.schedule_names}")
    if cfg.moe:
        log(f"[{tag}] aux metrics of the last step: moe_balance {float(m['moe_balance']):.4f}, moe_zloss "
            f"{float(m['moe_zloss']):.4f}")
    log(f"[{tag}] step wall ms {[round(w, 2) for w in walls]}; median of steps 2-{n_steps} {step_ms:.2f} ms, "
        f"{tokens / step_ms * 1e3:.1f} tokens/s, model {model_flops / 1e12:.1f} TFLOP a step "
        f"(6·N{'_active' if cfg.moe else ''}·tokens + attention, no recompute) = {tflops:.1f} TFLOP/s, "
        f"{tflops / 989:.1%} of 989; peak device memory {peak / 2**30:.2f} GiB ({peak} bytes)")
    state, spans = _codelet_times(art, state, batches[n_steps])
    log(f"[{tag}] device time of each task of one step: "
        + ", ".join(f"{name} {ms:.1f} ms" for name, ms in spans))
    state, _, prof = _profile_train_step(art, state, batches[n_steps])
    log(f"[profile] one {arch} train step under the profiler: {prof['profiled_wall_ms']:.2f} ms wall, "
        f"{prof['device_ms']:.2f} ms device time, device busy {prof['busy']:.1%}")
    for name, ms in prof["top"]:
        log(f"[profile]   {ms:9.3f} ms  {name}")
    log("[profile] by kind: " + ", ".join(f"{k} {ms:.1f} ms ({ms / prof['device_ms']:.1%})"
                                          for k, ms in prof["kinds"]))
    out = dict(launches=launches, losses=losses, grad_norms=gnorms, walls_ms=walls, step_ms=step_ms,
               tokens_per_s=tokens / step_ms * 1e3, model_tflops=tflops, peak_bytes=peak, profile=prof,
               task_ms=spans)
    if not rollback:
        del state, art, batches
        gc.collect()
        torch.cuda.empty_cache()
        return out
    # nonfinite rollback: a NaN in one ln1 scale; every bit stays, the step advances
    with torch.no_grad():
        state.params.layers[0].ln1.scale[0] = float("nan")
    before = {n: _bits(p).cpu() for n, p in state.params.named_parameters()}
    opt_before = {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in state.opt.items()}
    step_before = int(state.step)
    state, m = art(state, batches[n_steps + 1])
    gn = float(m["grad_norm"])
    assert not np.isfinite(gn), gn
    assert int(state.step) == step_before + 1
    for n, p in state.params.named_parameters():
        assert torch.equal(_bits(p).cpu(), before[n]), f"rollback changed {n}"
    for k, v in state.opt.items():
        for kk, vv in v.items():
            assert torch.equal(_bits(vv), _bits(opt_before[k][kk])), f"rollback changed opt {k}/{kk}"
    log(f"[{tag}] nonfinite rollback: grad norm {gn}, every parameter ({len(before)} tensors) and "
        f"optimizer tensor bit-identical, step {step_before} -> {int(state.step)}")
    del state, art, batches, before, opt_before
    gc.collect()
    torch.cuda.empty_cache()
    return out


M2_BATCH, M2_SEQ, M2_MB, M2_STEPS = 8, 2048, 2, 4


def train_m2_phase(dev) -> dict:
    """mamba2-130m training on the card.  Parity: full width and 2 layers
    in fp32, two staged steps (B = 2, L = 512, 2 microbatches) with the
    config's AdamW against the CPU port (``_parity_run``).  Then the full
    24 layers in bf16 (AdamW, ``remat="full"``, logits in chunks of 1024),
    a global batch of (8, 2048) in two microbatches: 4 staged steps with
    finite losses and exact launch counts of the ssd, ssd_bwd, rmsnorm and
    rmsnorm_bwd kernels; step time, tokens/s, peak memory; one profiled
    step."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.train import build_train_step, init_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config("mamba2-130m")
    assert (full.remat, full.dtype, full.n_layers, full.optimizer, full.logits_chunk) == (
        "full", "bfloat16", 24, "adamw", 1024)
    parity = _parity_run(dev, full.replace(n_layers=2, dtype="float32", logits_chunk=256), tag="train-m2",
                         seq=512)
    state = init_train_state(full, 0, device=dev)
    n_params = sum(p.numel() for p in state.params.parameters())
    art = build_train_step(full, n_microbatches=M2_MB, schedule_policy="overlap")
    batches = _batches(full, dev, M2_STEPS + 1, M2_BATCH, M2_SEQ)  # + the profiled step
    ops = _kernel_ops()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts from 0 just before, read just after ----
    for c in ops.values():
        c.reset()
    walls, losses, gnorms = [], [], []
    for b in batches[:M2_STEPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = art(state, b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    launches = {name: c.count for name, c in ops.items()}
    # ------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * M2_STEPS for k, v in _train_launches_per_step(full, M2_MB).items()}
    log(f"[train-m2] mamba2-130m ({full.n_layers} layers, {n_params / 1e6:.1f} M params, {full.dtype}, "
        f"{full.optimizer}, remat {full.remat}): launches on the main path {launches}; expected {want} "
        f"from {M2_STEPS} steps of {M2_MB} microbatches")
    assert launches == want, "the mamba2 train step did not run through every kernel as expected"
    assert all(np.isfinite(losses)) and all(np.isfinite(gnorms)), (losses, gnorms)
    tokens = M2_BATCH * M2_SEQ
    step_ms = float(np.median(walls[1:]))
    log(f"[train-m2] losses {losses}, grad norms {gnorms}; step wall ms {[round(w, 2) for w in walls]}; "
        f"median of steps 2-{M2_STEPS} {step_ms:.2f} ms, {tokens / step_ms * 1e3:.1f} tokens/s; peak device "
        f"memory {peak / 2**30:.2f} GiB ({peak} bytes)")
    state, _, prof = _profile_train_step(art, state, batches[M2_STEPS])
    log(f"[profile] one mamba2 train step under the profiler: {prof['profiled_wall_ms']:.2f} ms wall, "
        f"{prof['device_ms']:.2f} ms device time, device busy {prof['busy']:.1%}")
    for name, ms in prof["top"]:
        log(f"[profile]   {ms:9.3f} ms  {name}")
    log("[profile] by kind: " + ", ".join(f"{k} {ms:.1f} ms ({ms / prof['device_ms']:.1%})"
                                          for k, ms in prof["kinds"]))
    del state, art, batches
    gc.collect()
    torch.cuda.empty_cache()
    return dict(parity=parity, launches=launches, losses=losses, grad_norms=gnorms, walls_ms=walls,
                step_ms=step_ms, tokens_per_s=tokens / step_ms * 1e3, peak_bytes=peak, profile=prof)


# ---------------------------------------------------------------------------
# 11-12. speculative decoding and the load generator at full width
# ---------------------------------------------------------------------------

SPEC_K = 4
# the speculation and load phases' deepseek-7b, cut in depth to keep the
# script inside its time limit (the serving and train phases run all 30)
SPEC_LAYERS = 12
LOAD_SPEC = dict(seed=0, n_requests=16, rate_rps=2.0, prompt_lens=(128, 512, 1024, 2048),
                 out_lens=(16, 32), vocab=32000, dup_frac=0.25)


def _layer_launches(cfg) -> dict:
    """Kernel calls of one forward of ``cfg``: flash attention a prefill and
    decode attention a decode step for each attention layer (``attn`` and
    ``moe``; MLA decodes in latent space with torch ops, ``rec`` and ``ssm``
    layers run none), the ssd kernel per ssm layer a prefill, and the norms
    (two per layer, four with qk_norm or MLA's latent norms, one for an
    ssm block) plus the final norm."""
    from repro_torch.models import layer_kinds

    kinds = layer_kinds(cfg)
    norms = {"ssm": 1, "rec": 2, "mla": 4, "attn": 2 + 2 * cfg.qk_norm, "moe": 2 + 2 * cfg.qk_norm}
    return dict(flash=sum(k in ("attn", "moe", "mla") for k in kinds),
                decode=sum(k in ("attn", "moe") for k in kinds),
                ssd=sum(k == "ssm" for k in kinds),
                norms=sum(norms[k] for k in kinds) + 1)


def _serve_launches(cfg, *, prefills, decode_steps, draft_layers=0, primes=0, draft_feeds=0,
                    verify_substeps=0) -> dict:
    """Kernel launches of a serving run (``_layer_launches`` a forward): the
    target's prefills, decode steps and verify sub-steps; the draft
    (``draft_layers`` deep) primes each speculative admission with a
    prefill and feeds its own decode steps."""
    c = _layer_launches(cfg)
    d = _layer_launches(cfg.replace(n_layers=draft_layers)) if draft_layers else dict.fromkeys(c, 0)
    fwd = prefills + decode_steps + verify_substeps
    return {
        "flash_attention": c["flash"] * prefills + d["flash"] * primes,
        "decode_attention": c["decode"] * (decode_steps + verify_substeps) + d["decode"] * draft_feeds,
        "rmsnorm": c["norms"] * fwd + d["norms"] * (primes + draft_feeds),
        "ssd": c["ssd"] * prefills, "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "ssd_bwd": 0,
    }


def _verify_substeps(sp: dict, k: int) -> int:
    """Sub-steps the verify bodies ran: k + 1 a committed round; an aborted
    round runs its body twice (speculatively, then on rollback) at T = 1."""
    return (sp["rounds"] - sp["rollback_rounds"]) * (k + 1) + 2 * sp["rollback_rounds"]


def _spec_run(cfg, model, dev, prompts, sampled_prompt, warm, draft=None, rollback=0) -> dict:
    """One engine (plain, or with ``draft`` = (cfg, model) at k = SPEC_K):
    a warm-up wave, then the serving phase's four requests, every engine
    iteration timed (host clock, synchronised).  Launch counts from 0 just
    before the requests, read after."""
    from repro_torch.serving import ServeEngine

    kw = {} if draft is None else dict(draft_cfg=draft[0], draft_params=draft[1], draft_k=SPEC_K)
    ops = _kernel_ops()
    gc.collect()  # the previous run's engine and caches
    torch.cuda.empty_cache()
    with ServeEngine(cfg, model, n_slots=N_SLOTS, max_seq=MAX_SEQ, block_size=BLOCK_SIZE,
                     device=dev, **kw) as eng:
        for p in warm:
            eng.submit(p, 2)
        eng.run_until_drained()
        spec0 = eng._spec.stats() if draft else {}
        graph0 = dict(eng._tg.spec_stats)
        base = (eng.prefills, eng.restores, eng.decode_steps)
        torch.cuda.synchronize()
        for c in ops.values():
            c.reset()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, GEN) for p in prompts]
        reqs.append(eng.submit(sampled_prompt, GEN, temperature=0.8, top_k=40, seed=7))
        eng.step()  # admissions
        if rollback:
            eng.force_rollback(rollback)
        round_ms = []
        while eng.scheduler.queue_depth or eng.n_running:
            rounds = eng._spec.rounds if draft else 0
            t1 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            if draft and eng._spec.rounds > rounds:
                round_ms.append((time.perf_counter() - t1) * 1e3)
        wall = time.perf_counter() - t0
        launches = {name: c.count for name, c in ops.items()}
        out = dict(streams=[r.out_tokens for r in reqs], reqs=reqs, wall=wall, launches=launches,
                   round_ms=round_ms, prefills=eng.prefills - base[0],
                   restores=eng.restores - base[1], decode_steps=eng.decode_steps - base[2])
        if draft:
            sp = eng._spec.stats()
            out["spec"] = {k: sp[k] - spec0[k] for k in ("rounds", "rollback_rounds", "sheds",
                                                         "draft_feeds", "proposed", "accepted",
                                                         "committed_tokens")}
            out["graph"] = {k: v - graph0[k] for k, v in eng._tg.spec_stats.items()}
            out["profile"] = _profile_round(eng, warm)
    assert all(r.done and len(r.out_tokens) == GEN for r in reqs), "a request did not finish"
    return out


def _profile_round(eng, prompts) -> dict:
    """One speculation round with every slot busy, under the profiler:
    device time by kernel and the device-busy share (outside the counted
    window)."""
    from torch.profiler import ProfilerActivity, profile

    reqs = [eng.submit(p, GEN) for p in prompts]
    eng.step()  # admissions
    rounds = eng._spec.rounds
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    assert eng._spec.rounds == rounds + 1, "the profiled step was not a speculation round"
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    return _device_rows(prof, wall_ms, 1)


def _deepseek(dev, tag: str):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    gc.collect()  # earlier phases' models and engines are cyclic garbage
    torch.cuda.empty_cache()
    cfg = get_config("deepseek-7b").replace(n_layers=SPEC_LAYERS)
    t0 = time.perf_counter()
    model = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    log(f"[{tag}] deepseek-7b ({cfg.n_layers} of 30 layers, full width, {cfg.dtype}, seed 0) initialised on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    return cfg, model


def spec_phase(dev, cfg, model) -> dict:
    """Full-width deepseek-7b, the serving phase's geometry and requests,
    greedy and sampled: the plain engine, then the 1-layer shrunken draft
    at k = 4 (alone, then with two forced rollbacks), then the target as its
    own draft.  Every stream equals the plain engine's; the self draft's
    greedy accept rate is 1.0; launch counts exact."""
    from repro_torch.serving import shrunken_draft

    rng = np.random.default_rng(0)  # the serving phase's prompts
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in PROMPT_LENS]
    sampled_prompt = rng.integers(0, cfg.vocab, size=SAMPLED_LEN).astype(np.int32)
    warm = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in PROMPT_LENS + (SAMPLED_LEN,)]
    run = lambda **kw: _spec_run(cfg, model, dev, prompts, sampled_prompt, warm, **kw)  # noqa: E731

    plain = run()
    want = _serve_launches(cfg, prefills=plain["prefills"], decode_steps=plain["decode_steps"])
    assert plain["launches"] == want, (plain["launches"], want)
    n_tok = sum(len(s) for s in plain["streams"])
    log(f"[spec] plain engine: {n_tok} tokens in {plain['wall']:.3f} s ({n_tok / plain['wall']:.1f} tok/s), "
        f"{plain['decode_steps']} decode steps; launches {plain['launches']}")
    one = shrunken_draft(cfg, model, n_layers=1)
    runs = {"1-layer draft": run(draft=one), "1-layer draft, 2 forced rollbacks": run(draft=one, rollback=2),
            "self draft": run(draft=(cfg, model))}
    out = {"plain": dict(tok_per_s=n_tok / plain["wall"], launches=plain["launches"])}
    for name, r in runs.items():
        dl = (one[0] if name.startswith("1-layer") else cfg).n_layers
        sp, g = r["spec"], r["graph"]
        assert sp["sheds"] == 0, sp
        sub = _verify_substeps(sp, SPEC_K)
        want = _serve_launches(cfg, prefills=r["prefills"], decode_steps=r["decode_steps"],
                               draft_layers=dl, primes=r["prefills"] + r["restores"],
                               draft_feeds=sp["draft_feeds"], verify_substeps=sub)
        log(f"[spec] {name}: launches {r['launches']}; expected {want} from {r['prefills']} prefills, "
            f"{r['decode_steps']} plain decode steps, {sp['draft_feeds']} draft feeds x {dl} layers, "
            f"{sub} verify sub-steps x {cfg.n_layers} ({sp['rounds']} rounds, {sp['rollback_rounds']} "
            f"rolled back)")
        assert r["launches"] == want, "the speculative path did not run through its kernels as expected"
        assert r["streams"] == plain["streams"], (name, r["streams"], plain["streams"])
        n_tok = sum(len(s) for s in r["streams"])
        rate = sp["accepted"] / max(sp["proposed"], 1)
        prof = r["profile"]
        log(f"[spec] {name}: streams equal the plain engine's (sampled one included); accept rate "
            f"{rate:.3f}, {sp['committed_tokens'] / max(sp['rounds'], 1):.2f} committed tokens a round, "
            f"round wall ms median {np.median(r['round_ms']):.2f} (min {min(r['round_ms']):.2f}, max "
            f"{max(r['round_ms']):.2f}); {n_tok} tokens in {r['wall']:.3f} s ({n_tok / r['wall']:.1f} tok/s "
            f"vs plain {out['plain']['tok_per_s']:.1f}); graph {g}")
        log(f"[profile] one {name} round, 4 busy slots: {prof['profiled_wall_ms']:.2f} ms wall, "
            f"{prof['device_ms']:.2f} ms device time, device busy {prof['busy']:.1%}; by kind: "
            + ", ".join(f"{k} {ms:.2f} ms" for k, ms in prof["kinds"]))
        out[name] = dict(launches=r["launches"], accept_rate=rate, rounds=sp["rounds"],
                         per_round=sp["committed_tokens"] / max(sp["rounds"], 1),
                         round_ms=float(np.median(r["round_ms"])), tok_per_s=n_tok / r["wall"],
                         busy=prof["busy"], device_ms=prof["device_ms"])
    roll = runs["1-layer draft, 2 forced rollbacks"]
    assert roll["spec"]["rollback_rounds"] >= 2 and roll["graph"]["rollbacks"] >= 2, roll["spec"]
    greedy = [r for r in runs["self draft"]["reqs"] if r.temperature == 0.0]
    acc = sum(r.spec_accepted for r in greedy) / sum(SPEC_K * r.spec_rounds for r in greedy)
    log(f"[spec] self draft: greedy accept rate {acc} over {sum(r.spec_rounds for r in greedy)} request rounds")
    assert acc == 1.0, acc
    out["launches"] = {name: plain["launches"][name] + sum(r["launches"][name] for r in runs.values())
                       for name in plain["launches"]}
    return out


def load_phase(dev, cfg, model) -> dict:
    """``run_load`` on full-width deepseek-7b (``LOAD_SPEC``): continuous,
    drain, then continuous with the 1-layer draft at k = 4 and
    ``speculative=True``; equal output checksums, exact launch counts over
    each engine's life (the warm-up included)."""
    from repro_torch.serving import LoadSpec, ServeEngine, build_workload, run_load, shrunken_draft

    spec = LoadSpec(**LOAD_SPEC)
    workload = build_workload(spec)
    one = shrunken_draft(cfg, model, n_layers=1)
    ops = _kernel_ops()
    out = {"launches": {name: 0 for name in ops}}
    checksums = set()
    for name, mode, draft in (("continuous", "continuous", None), ("drain", "drain", None),
                              ("continuous, 1-layer draft", "continuous", one)):
        kw = {} if draft is None else dict(draft_cfg=draft[0], draft_params=draft[1], draft_k=SPEC_K)
        run_spec = LoadSpec(**LOAD_SPEC, speculative=draft is not None)
        torch.cuda.synchronize()
        for c in ops.values():
            c.reset()
        with ServeEngine(cfg, model, n_slots=N_SLOTS, max_seq=MAX_SEQ, block_size=BLOCK_SIZE,
                         device=dev, **kw) as eng:
            res = run_load(eng, workload, mode=mode, spec=run_spec)
            torch.cuda.synchronize()
            launches = {k: c.count for k, c in ops.items()}
            st = res["engine"]
            sp = st.get("spec")
            want = _serve_launches(
                cfg, prefills=st["prefills"], decode_steps=eng.decode_steps,
                draft_layers=draft[0].n_layers if draft else 0,
                primes=st["prefills"] + st["restores"] if draft else 0,
                draft_feeds=sp["draft_feeds"] if sp else 0,
                verify_substeps=_verify_substeps(sp, SPEC_K) if sp else 0)
        log(f"[load] {name}: launches {launches}; expected {want} ({st['prefills']} prefills, "
            f"{st['restores']} restores, {eng.decode_steps} plain decode steps"
            + (f", {sp['rounds']} rounds ({sp['rollback_rounds']} rolled back, {sp['sheds']} shed), "
               f"{sp['draft_feeds']} draft feeds, accept rate {sp['accept_rate']:.3f}" if sp else "") + ")")
        assert launches == want, "the load generator's path did not run through its kernels as expected"
        log(f"[load] {name}: {res['requests']} requests ({res['rejected']} rejected), {res['tokens']} tokens "
            f"in {res['elapsed_s']:.2f} s, {res['tokens_per_s']:.1f} tok/s; TTFT p50 {res['ttft_p50_ms']:.1f} "
            f"ms p99 {res['ttft_p99_ms']:.1f} ms; ITL p50 {res['itl_p50_ms']:.1f} ms p99 "
            f"{res['itl_p99_ms']:.1f} ms; output checksum {res['output_checksum']}")
        assert res["requests"] + res["rejected"] == spec.n_requests and res["tokens"] > 0
        checksums.add(res["output_checksum"])
        out[name] = {k: res[k] for k in ("output_checksum", "requests", "rejected", "tokens", "tokens_per_s",
                                         "ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms", "itl_p99_ms")}
        for k, v in launches.items():
            out["launches"][k] += v
    assert len(checksums) == 1, f"output checksums differ: {checksums}"
    log(f"[load] the three runs' output checksums are equal: {checksums.pop()}")
    return out


# ---------------------------------------------------------------------------
# 13. checkpoint and resume
# ---------------------------------------------------------------------------

CKPT_LAYERS, CKPT_STEPS, CKPT_EVERY = 4, 4, 2
CKPT_DIR = Path(__file__).resolve().parent / "_smoke_ckpt"


def _state_tensors(state) -> dict:
    out = {f"params/{n}": p for n, p in state.params.named_parameters()}
    for k, v in state.opt.items():
        out.update({f"opt/{k}/{kk}": vv for kk, vv in v.items()})
    out["step"] = state.step
    return out


def _max_diff(a, b) -> float:
    """Largest absolute difference between two states' tensors (0.0: the
    same bits, NaN aside)."""
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert ta.keys() == tb.keys()
    worst = 0.0
    for k in ta:
        if not torch.equal(_bits(ta[k]), _bits(tb[k])):
            worst = max(worst, float((ta[k].float() - tb[k].float()).abs().max()), 1e-30)
    return worst


def _train_run(cfg, dev, mgr=None, resume_from=None, expect=None) -> dict:
    """``launch/train.py``'s calls: a fresh seeded state, restored from
    ``mgr`` at step ``resume_from`` when given (and compared bit for bit
    with ``expect`` at once: training updates it in place), then
    ``train_loop`` to CKPT_STEPS, saving every CKPT_EVERY steps when
    ``mgr`` is given and not resuming."""
    from repro_torch.launch.train import train_loop
    from repro_torch.runtime.train import init_train_state

    state = init_train_state(cfg, 0, device=dev)
    out = {}
    start = 0
    if resume_from is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start, state = mgr.restore(state, step=resume_from)
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        got = _state_tensors(state)
        assert got.keys() == expect.keys()
        out["n_tensors"] = len(got)
        out["restored_equal"] = all(torch.equal(_bits(got[k]), _bits(expect[k])) for k in got)
    out["state"], out["losses"] = train_loop(
        cfg, state, steps=CKPT_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=TRAIN_MB,
        start_step=start, mgr=mgr, ckpt_every=CKPT_EVERY if resume_from is None else 0)
    return out


def ckpt_phase(dev) -> dict:
    """deepseek-7b at full width and 4 layers (bf16, Adafactor, remat
    "full", (2, 2048) in 2 microbatches) through the launcher's loop
    (``launch/train.py::train_loop``) and ``CheckpointManager`` calls: two
    unbroken 4-step runs (the first saving every 2 steps), then a fresh
    state resumed from step 2; the restored
    state bit for bit the saved one, the resumed losses and parameters the
    unbroken run's (bitwise if two unbroken runs agree bitwise, else within
    their spread).  The directory is removed at the end."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("deepseek-7b").replace(optimizer="adafactor", n_layers=CKPT_LAYERS)
    assert (cfg.remat, cfg.dtype) == ("full", "bfloat16")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    ops = _kernel_ops()
    for c in ops.values():
        c.reset()
    class KeepingManager(CheckpointManager):
        """Times the save at step CKPT_EVERY (the caller's thread, then its
        commit, waited for at once) and keeps a device copy of that state."""

        def save(self, step, state, **kw):
            t0 = time.perf_counter()
            super().save(step, state, **kw)
            t1 = time.perf_counter()
            if step == CKPT_EVERY:
                self.wait()
                self.times = (t1 - t0, time.perf_counter() - t1)
                self.kept = {k: t.clone() for k, t in _state_tensors(state).items()}

    try:
        mgr = KeepingManager(str(CKPT_DIR), keep=3)
        a = _train_run(cfg, dev, mgr=mgr)
        a["save_s"], a["commit_s"] = mgr.times
        assert mgr.all_steps() == [CKPT_EVERY, CKPT_STEPS], mgr.all_steps()
        b = _train_run(cfg, dev)
        r = _train_run(cfg, dev, mgr=mgr, resume_from=CKPT_EVERY, expect=mgr.kept)
        del mgr.kept
        launches = {name: c.count for name, c in ops.items()}
        n_steps = 2 * CKPT_STEPS + (CKPT_STEPS - CKPT_EVERY)
        want = {k: v * n_steps for k, v in _train_launches_per_step(cfg, TRAIN_MB).items()}
        log(f"[ckpt] launches {launches}; expected {want} from {n_steps} steps")
        assert launches == want, "the train steps did not run through every kernel as expected"
        d = CKPT_DIR / f"step_{CKPT_EVERY:09d}"
        n_bytes = sum(f.stat().st_size for f in d.iterdir() if f.suffix == ".npy")
        same = r["restored_equal"]
        log(f"[ckpt] step {CKPT_EVERY}: {r['n_tensors']} tensors, {n_bytes} bytes in "
            f"{len(list(d.glob('*.npy')))} files; save {a['save_s']:.3f} s on the caller's thread, commit "
            f"{a['commit_s']:.3f} s ({n_bytes / (a['save_s'] + a['commit_s']) / 1e9:.2f} GB/s for both), restore "
            f"{r['restore_s']:.3f} s ({n_bytes / r['restore_s'] / 1e9:.2f} GB/s); restored state bit-identical "
            f"to the saved one: {same}")
        assert same, "the restored state differs from the saved one"
        spread_loss = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
        spread = _max_diff(a["state"], b["state"])
        got_loss = max(abs(x - y) for x, y in zip(a["losses"][CKPT_EVERY:], r["losses"]))
        got = _max_diff(a["state"], r["state"])
        log(f"[ckpt] losses: unbroken {a['losses']}, again {b['losses']}, resumed at {CKPT_EVERY} "
            f"{r['losses']}")
        log(f"[ckpt] two unbroken runs: max loss difference {spread_loss}, max final-state difference "
            f"{spread}; resumed vs unbroken: {got_loss}, {got}"
            + (" (bitwise)" if spread_loss == spread == got_loss == got == 0.0 else ""))
        assert all(np.isfinite(a["losses"])) and len(r["losses"]) == CKPT_STEPS - CKPT_EVERY
        assert got_loss <= spread_loss and got <= spread, "the resumed run left the unbroken runs' spread"
        return dict(launches=launches, bytes=n_bytes, save_s=a["save_s"], commit_s=a["commit_s"],
                    restore_s=r["restore_s"], spread=(spread_loss, spread), resumed=(got_loss, got))
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 14. communication in the task graph
# ---------------------------------------------------------------------------

COMM_RANKS = 4
COMM_DEVICE = "cuda"  # every payload's device; results anywhere else fail
COMM_CHUNK = 4 << 20  # chunk pipelining: 4 MiB pieces
COMM_BF16_N = 1 << 20
COMM_LAUNCH = ["--arch", "mamba2-130m", "--steps", "3", "--batch", "8", "--seq", "1024",
               "--microbatches", "2", "--log-every", "1"]


def _comm_n() -> int:
    """The payload: mamba2-130m's parameter count, the gradient a
    data-parallel rank of that model reduces."""
    from repro_torch.configs import get_config

    return get_config("mamba2-130m").param_count()


def _busbw(size: int, nbytes: int, wall_s: float) -> float:
    """Ring all-reduce bus bandwidth, GB/s: 2·(S−1)/S of the bytes a rank
    holds, over the wall time."""
    return 2 * (size - 1) / size * nbytes / wall_s / 1e9


def _hub_run(values, insert, *, device=None):
    """One collective over one ``ChannelHub``: rank r an eager ``SpRuntime``
    with one ``cuda`` worker, its group on ``device``, its cell holding
    ``values[r]``; ``insert(graph, group, cell)`` inserts the collective.
    Returns (each rank's result, wall seconds to the last result)."""
    from repro_torch.core import ChannelHub, SpCommGroup, SpData, SpRuntime, SpWorkerTeam

    size = len(values)
    hub = ChannelHub()
    rts = [SpRuntime(workers=SpWorkerTeam(["cuda"])) for _ in range(size)]
    try:
        groups = [SpCommGroup(r, size, hub, default_timeout=120.0, device=device or COMM_DEVICE)
                  for r in range(size)]
        cells = [SpData(v, f"x{r}") for r, v in enumerate(values)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        views = [insert(rt.graph, g, c) for rt, g, c in zip(rts, groups, cells)]
        for rt in rts:
            rt.graph.wait_all_tasks()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert hub.stats()["boxes"] == 0, hub.stats()
        return [v.get_value() for v in views], wall
    finally:
        for rt in rts:
            rt.stop()


def _on_card(t, name: str) -> None:
    for x in t if isinstance(t, list) else [t]:
        if x.device.type != COMM_DEVICE:
            raise AssertionError(f"{name}: a payload arrived on {x.device}, not on the card")


def _sleeping_write(x, value: float) -> None:
    torch.cuda._sleep(1_000_000_000)  # ~0.5 s of a kernel queued ahead of the write
    x.fill_(value)


def _comm_stream_order(dev) -> dict:
    """A task on the card queues a long kernel, then a write, and returns at
    once; the send after it runs on the comm thread.  Over the hub to a
    group on the CPU (the receiver's comm thread copies the tensor to the
    host) and over a socket pair to a group on the card (the sender's comm
    thread copies it to the host, the receiver's back to the card), what
    arrives is the written value."""
    from repro_torch.core import (ChannelHub, SocketTransport, SpCommGroup, SpComputeEngine, SpData,
                                  SpTaskGraph, SpWorkerTeam, SpWrite, mpi_recv, mpi_send)

    out = {}
    eng = SpComputeEngine(SpWorkerTeam(["cuda", "cuda"]))  # device workers
    try:
        for wire, recv_dev in (("hub", "cpu"), ("sockets", COMM_DEVICE)):
            if wire == "sockets":
                t0 = SocketTransport(0, 2)
                hubs = [t0, SocketTransport(1, 2, port=t0.port)]
            else:
                hubs = [ChannelHub()] * 2
            try:
                g0 = SpCommGroup(0, 2, hubs[0], device=dev)
                g1 = SpCommGroup(1, 2, hubs[1], device=recv_dev)
                tg0, tg1 = SpTaskGraph().compute_on(eng), SpTaskGraph().compute_on(eng)
                x, r = SpData(torch.zeros(1 << 24, device=dev), "x"), SpData(None, "r")
                torch.cuda.synchronize()
                t_start = time.perf_counter()
                tg0.task(SpWrite(x), lambda ref: _sleeping_write(ref.value, 7.0))
                mpi_send(tg0, g0, x, dest=1, tag="w")
                mpi_recv(tg1, g1, r, src=0, tag="w", timeout=120.0)
                tg0.wait_all_tasks()
                tg1.wait_all_tasks()
                arrived = time.perf_counter() - t_start
                got = r.value
                assert got.device.type == recv_dev, (wire, got.device)
                ok = bool(torch.equal(got, torch.full_like(got, 7.0)))
                log(f"[comm] stream order over the {wire} to a {recv_dev} group: 64 MiB written behind a "
                    f"~0.5 s kernel arrived after {arrived:.3f} s holding the written value: {ok}")
                assert ok, f"{wire}: the send overtook the kernel that writes the tensor"
                out[wire] = arrived
            finally:
                for h in reversed(hubs):
                    h.close()
    finally:
        eng.stop()
    return out


def _comm_in_process(dev, n: int) -> dict:
    """(a) Four ranks on one hub, groups on the card, ``_det_grad`` payloads
    of ``n`` float32: ring sum and mean with and without chunk pipelining,
    the all-gather, the hierarchical all-reduce at 2 × 2, a bf16 case; every
    result a CUDA tensor, bit for bit the card's own sum of the inputs."""
    from repro_torch.dist import collectives as coll
    from repro_torch.launch.rendezvous import _det_grad

    S = COMM_RANKS
    xs = [torch.from_numpy(_det_grad(r, 0, n)).to(dev) for r in range(S)]
    total = xs[0] + xs[1] + xs[2] + xs[3]  # integer-valued below 2**24: exact in any order
    nbytes = n * 4
    out = {}
    for op in ("sum", "mean"):
        want = total if op == "sum" else total / S
        for chunk in (None, COMM_CHUNK):
            got, wall = _hub_run(xs, lambda g, grp, c: coll.ring_all_reduce(
                g, grp, c, op=op, tag=0, chunk_bytes=chunk))
            _on_card(got, "ring_all_reduce")
            exact = all(torch.equal(v, want) for v in got)
            key = f"ring {op} chunk {chunk}"
            out[key] = dict(wall_s=wall, busbw=_busbw(S, nbytes, wall), exact=exact)
            log(f"[comm] in-process {key}: {S} ranks x {n} float32 ({nbytes / 1e9:.3f} GB a rank): "
                f"{wall * 1e3:.1f} ms, bus {_busbw(S, nbytes, wall):.2f} GB/s; bit for bit: {exact}")
            assert exact, key
            del got
    got, wall = _hub_run(xs, lambda g, grp, c: coll.ring_all_gather(g, grp, c, tag=1))
    exact = all(len(v) == S and all(torch.equal(a, b) for a, b in zip(v, xs)) for v in got)
    for v in got:
        _on_card(v, "ring_all_gather")
    out["gather"] = dict(wall_s=wall, exact=exact)
    log(f"[comm] in-process all-gather: {wall * 1e3:.1f} ms, {S} x {nbytes / 1e9:.3f} GB gathered "
        f"a rank; bit for bit: {exact}")
    assert exact, "ring_all_gather"
    del got
    got, wall = _hub_run(xs, lambda g, grp, c: coll.hierarchical_all_reduce(g, grp, c, pod_size=2, tag=2))
    _on_card(got, "hierarchical_all_reduce")
    exact = all(torch.equal(v, total) for v in got)
    out["hier"] = dict(wall_s=wall, exact=exact)
    log(f"[comm] in-process hierarchical all-reduce (2 pods x 2): {wall * 1e3:.1f} ms; bit for bit: {exact}")
    assert exact, "hierarchical_all_reduce"
    del got, xs, total
    # bf16: integers below 64 a rank, so every partial sum (< 256) is exact
    bs = [((torch.arange(COMM_BF16_N, device=dev) % 61) + r).to(torch.bfloat16) for r in range(S)]
    btotal = bs[0] + bs[1] + bs[2] + bs[3]
    for op, want in (("sum", btotal), ("mean", btotal / S)):
        got, wall = _hub_run(bs, lambda g, grp, c: coll.ring_all_reduce(g, grp, c, op=op, tag=3))
        _on_card(got, "bf16 ring")
        exact = all(v.dtype == torch.bfloat16 and torch.equal(v.view(torch.int16), want.view(torch.int16))
                    for v in got)
        log(f"[comm] in-process bf16 ring {op} of {COMM_BF16_N} elements: {wall * 1e3:.1f} ms; bit for bit: "
            f"{exact}")
        assert exact, f"bf16 {op}"
        out[f"bf16 {op}"] = dict(wall_s=wall, exact=exact)
    out["stream_order"] = _comm_stream_order(dev)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _digest_check(name, reports, key, want_digest) -> None:
    for rank, rep in sorted(reports.items()):
        if not rep["device"].startswith(COMM_DEVICE):
            raise AssertionError(f"{name}: rank {rank}'s result lived on {rep['device']}, not on the card")
        if rep[key] != want_digest:
            raise AssertionError(f"{name}: rank {rank}'s {key} differs from the oracle")


def _comm_processes(n: int) -> dict:
    """(b) Rank processes over the socket transport, payloads on the card:
    ``run_ring_reduce`` at 2 and 4 ranks, ``run_collective`` all-gather and
    hierarchical (2 × 2), and the legacy star (``RouterTransport``) at 2
    ranks as the baseline; each result bit for bit its NumPy oracle."""
    from repro_torch.launch import rendezvous as rdv

    inputs = [rdv._normal_input(r, n) for r in range(COMM_RANKS)]
    nbytes = n * 4
    out = {}
    # the star at 2 ranks: each of its reduces moves 1 GB through rank 0's
    # Python router (3 GB at 4 ranks, ~9 s a reduce)
    for size, transport in ((2, "p2p"), (4, "p2p"), (2, "router")):
        t0 = time.perf_counter()
        steps = 3 if transport == "p2p" else 1
        res = rdv.run_ring_reduce(size, n, steps=steps, device=COMM_DEVICE, transport=transport,
                                  digest=True, timeout=600.0)
        total_s = time.perf_counter() - t0
        want = rdv.ring_order_sum(inputs[:size])
        _digest_check(f"ring {size} {transport}", res, "sum", rdv.payload_digest(want))
        _digest_check(f"ring {size} {transport}", res, "mean", rdv.payload_digest(want / np.float32(size)))
        walls = [rep["wall_s"] for rep in res.values()]
        d2h = [rep["d2h_s"] for rep in res.values()]
        key = f"ring {size} {transport}"
        out[key] = dict(walls=walls, busbw=[_busbw(size, nbytes, w) for w in walls], d2h_s=d2h,
                        total_s=total_s, stats=res[0]["stats"])
        log(f"[comm] {size} processes, {transport}: ring all-reduce of {nbytes / 1e9:.3f} GB a rank on the "
            f"card, bit for bit (sum and mean); per rank (median of {steps} sums) "
            + ", ".join(f"{w * 1e3:.1f} ms / {_busbw(size, nbytes, w):.2f} GB/s" for w in walls)
            + f"; D2H of one payload apart " + ", ".join(f"{d * 1e3:.1f} ms" for d in d2h)
            + f" ({nbytes / np.median(d2h) / 1e9:.2f} GB/s); {total_s:.1f} s with start-up; rank 0 "
            f"{res[0]['stats']}")
    del inputs
    grads = [rdv._det_grad(r, 0, n) for r in range(COMM_RANKS)]
    total = grads[0] + grads[1] + grads[2] + grads[3]
    for kind, kw, want in (("gather", {}, grads), ("hier", {"pod_size": 2}, total)):
        t0 = time.perf_counter()
        res = rdv.run_collective(COMM_RANKS, n, kind=kind, device=COMM_DEVICE, digest=True, timeout=600.0, **kw)
        total_s = time.perf_counter() - t0
        _digest_check(kind, res, "value", rdv.payload_digest(want))
        walls = [rep["wall_s"] for rep in res.values()]
        out[kind] = dict(walls=walls, total_s=total_s)
        log(f"[comm] {COMM_RANKS} processes, p2p: {kind} {kw} on the card, bit for bit; per rank "
            + ", ".join(f"{w * 1e3:.1f} ms" for w in walls) + f"; {total_s:.1f} s with start-up")
    return out


def _comm_rank_death(n: int) -> dict:
    """(c) Three rank processes on the card, the highest SIGKILLed inside a
    step's all-reduce: the elastic ring's survivors finish every step bit
    for bit (three-way ring order before the resume step, two-way after),
    the elastic train's survivors hold ``elastic_train_oracle``'s
    parameters bit for bit; the card's memory is back once the ranks are
    gone."""
    from repro_torch.launch import rendezvous as rdv

    free0 = torch.cuda.mem_get_info()[0]
    out = {}
    t0 = time.perf_counter()
    res, info = rdv.run_elastic_ring(size=3, n=n, steps=4, device=COMM_DEVICE, digest=True, timeout=600.0)
    total_s = time.perf_counter() - t0
    bases = [rdv._normal_input(r, n) for r in range(3)]
    full = rdv.payload_digest(rdv.ring_order_sum(bases))
    pair = rdv.payload_digest(rdv.ring_order_sum(bases[:2]))
    (resume,) = {rep["resume_step"] for rep in res.values()}
    for rank, rep in sorted(res.items()):
        assert rep["dead"] == [2] and rep["members"] == [0, 1] and rep["device"].startswith(COMM_DEVICE), rep
        for step, d in rep["steps"].items():
            if d != (full if step < resume else pair):
                raise AssertionError(f"elastic ring: rank {rank} step {step} differs from the oracle")
    lat = {r: rep["detect_at"] - info["t_kill"] for r, rep in res.items()}
    out["ring"] = dict(detect_s=lat, reroll_s={r: rep["reroll_s"] for r, rep in res.items()},
                       resume=resume, total_s=total_s)
    log(f"[comm] elastic ring, 3 processes, rank 2 SIGKILLed in step 2: survivors resumed at step {resume}, "
        f"every step bit for bit; detection after the kill "
        + ", ".join(f"rank {r} {v * 1e3:.1f} ms" for r, v in sorted(lat.items()))
        + "; re-roll " + ", ".join(f"{rep['reroll_s'] * 1e3:.1f} ms" for rep in res.values())
        + f"; {total_s:.1f} s in all")
    del bases
    t0 = time.perf_counter()
    res, info = rdv.run_elastic_train(size=3, n=n, steps=5, device=COMM_DEVICE, digest=True, timeout=600.0)
    total_s = time.perf_counter() - t0
    (resume,) = {rep["resume_step"] for rep in res.values()}
    want = rdv.payload_digest(rdv.elastic_train_oracle(3, n, 5, 0.01, resume_step=resume, dead=(2,)))
    for rank, rep in sorted(res.items()):
        assert rep["recoveries"] == 1 and rep["dead"] == [2] and rep["device"].startswith(COMM_DEVICE), rep
        if rep["params"] != want:
            raise AssertionError(f"elastic train: rank {rank}'s parameters differ from the oracle")
    lat = {r: rep["detect_at"] - info["t_kill"] for r, rep in res.items()}
    out["train"] = dict(detect_s=lat, reroll_s={r: rep["reroll_s"] for r, rep in res.items()},
                        resume=resume, total_s=total_s)
    log(f"[comm] elastic train, 3 processes, rank 2 SIGKILLed in step 2: resumed at step {resume}, the "
        f"survivors' parameters bit for bit elastic_train_oracle's; detection "
        + ", ".join(f"rank {r} {v * 1e3:.1f} ms" for r, v in sorted(lat.items()))
        + "; re-roll " + ", ".join(f"{rep['reroll_s'] * 1e3:.1f} ms" for rep in res.values())
        + f"; {total_s:.1f} s in all")
    time.sleep(1.0)
    free1 = torch.cuda.mem_get_info()[0]
    log(f"[comm] free device memory {free0 / 2**30:.2f} GiB before the rank processes, "
        f"{free1 / 2**30:.2f} GiB after they are gone")
    assert free1 >= free0 - (256 << 20), "a killed rank's device memory was not freed"
    return out


def _comm_launcher(dev) -> dict:
    """(d) ``launch.train.main`` on mamba2-130m at full width and depth with
    ``--fail-at 2:1 --bench-out``: the one-device line, 3 finite losses equal
    to a run without the flag (or within two such runs' spread), the JSON;
    exact kernel launch counts."""
    import contextlib
    import io
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train

    cfg = get_config("mamba2-130m")
    ops = _kernel_ops()
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        bench = Path(tmp) / "recovery.json"
        # ---- the main path: counts from 0 just before, read just after ----
        for c in ops.values():
            c.reset()
        argv = COMM_LAUNCH + ["--device", COMM_DEVICE]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            runs.append(launch_train.main(argv + ["--fail-at", "2:1", "--bench-out", str(bench)]))
        printed = buf.getvalue()
        runs.append(launch_train.main(argv))
        launches = {name: c.count for name, c in ops.items()}
        # ------------------------------------------------------------------
        written = json.loads(bench.read_text())
    for line in printed.splitlines():
        log(f"[comm] launcher | {line}")
    a, b = runs[0]["losses"], runs[1]["losses"]
    assert "failure injected but only one device; continuing" in printed
    assert written == {"recoveries": [], "final_step": 3}, written
    assert len(a) == 3 and all(np.isfinite(a)), a
    n_runs = 2
    if a != b:  # not bitwise: hold the difference within two plain runs' spread
        for c in ops.values():
            c.reset()
        c_losses = launch_train.main(argv)["losses"]
        launches = {k: launches[k] + c.count for k, c in ops.items()}
        n_runs = 3
        spread = max(abs(x - y) for x, y in zip(b, c_losses))
        assert max(abs(x - y) for x, y in zip(a, b)) <= spread, (a, b, c_losses)
    want = {k: v * 3 * n_runs for k, v in _train_launches_per_step(cfg, 2).items()}
    log(f"[comm] launcher --fail-at 2:1: losses {a}, without the flag {b}"
        + (" (bitwise)" if a == b else "") + f"; wrote {written}; launches {launches}, expected {want}")
    assert launches == want, "the launcher's train steps did not run through every kernel as expected"
    return dict(losses=a, plain=b, launches=launches)


def comm_phase(dev) -> dict:
    """14. Communication in the task graph at mamba2-130m's gradient size:
    (a) in-process, (b) across processes, (c) rank death, (d) the launcher."""
    gc.collect()
    torch.cuda.empty_cache()
    n = _comm_n()
    t0 = time.perf_counter()
    log(f"[comm] payload: mamba2-130m's {n} parameters as float32, {n * 4} bytes a rank")
    out, parts = {"n": n}, {}
    for key, part in (("in_process", lambda: _comm_in_process(dev, n)),
                      ("processes", lambda: _comm_processes(n)),
                      ("rank_death", lambda: _comm_rank_death(n)),
                      ("launcher", lambda: _comm_launcher(dev))):
        t1 = time.perf_counter()
        out[key] = part()
        parts[key] = time.perf_counter() - t1
    out["launches"] = out["launcher"]["launches"]
    out["seconds"] = time.perf_counter() - t0
    log(f"[comm] phase done in {out['seconds']:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    gc.collect()
    torch.cuda.empty_cache()
    return out


def f2_digests() -> dict:
    """ROADMAP F2: ``tools/ssd_grad_determinism.py``'s loop, short (5
    iterations, no test file), so every run prints each stage's digest of
    the ssd gradient's bits beside its card.  Logged, not asserted: F2 is
    the card test's own check."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tools" / "ssd_grad_determinism.py"
    spec = importlib.util.spec_from_file_location("ssd_grad_determinism", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    out = mod.run_loop(5)
    log(f"[f2] {out['iters']} iterations: stages that differ from the first {sorted(out['differing']) or 'none'}, "
        f"elements outside the card test's tolerance {out['elements_outside_the_test_tolerance']}, worst share "
        f"of the limit {out['worst_share_of_the_limit']:.3f}; TF32 {mod.tf32_state()}; "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"[f2] first-iteration digests {json.dumps(out['first_iteration_digest'])}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_s: dict = {}

    def phase(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t0
        log(f"[time] {name}: {phase_s[name]:.1f} s ({time.perf_counter() - t_start:.1f} s in all)")
        return out

    smi = header()
    launch_cost()
    dev = torch.device("cuda")
    build_s = build_kernels()
    records = phase("kernels", kernel_phase, dev)
    phase("f2", f2_digests)
    phase("codelets", codelet_phase, dev)
    examples = phase("examples", examples_phase, dev)
    serve = phase("serve", serving_phase, dev)
    serve_m = phase("mamba2", recurrent_serving_phase, dev)
    serve_g = phase("serve-gemma", serving_phase, dev, "gemma-7b", "serve-gemma")
    serve_c = phase("serve-minicpm3", serving_phase, dev, "minicpm3-4b", "serve-minicpm3")
    serve_r = phase("serve-rgemma", recurrent_serving_phase, dev, "recurrentgemma-9b", "serve-rgemma")
    serve_q = phase("serve-moe", serving_phase, dev, "qwen3-moe-235b-a22b", "serve-moe", n_layers=MOE_SERVE_LAYERS)
    from repro_torch.configs import get_config

    model_errs = {}
    for arch, n_layers, prompt_len in (("deepseek-7b", 2, 256), ("mamba2-130m", 4, 600), ("gemma-7b", 2, 256),
                                       ("minicpm3-4b", 2, 256), ("recurrentgemma-9b", 3, 256),
                                       ("qwen3-moe-235b-a22b", 1, 256)):
        cfg = get_config(arch).replace(n_layers=n_layers, dtype="float32")
        model_errs[arch] = phase(f"model {arch}", model_phase, dev, cfg, prompt_len=prompt_len)
    parity = phase("train-parity", train_parity_phase, dev)
    trains = {arch: phase(TRAIN_RUNS[arch][1], train_phase, dev, arch) for arch in TRAIN_RUNS}
    train, train_g = trains["deepseek-7b"], trains["gemma-7b"]
    train_m2 = phase("train-m2", train_m2_phase, dev)
    cfg, model = _deepseek(dev, "spec")
    spec = phase("spec", spec_phase, dev, cfg, model)
    load = phase("load", load_phase, dev, cfg, model)
    del model
    ckpt = phase("ckpt", ckpt_phase, dev)
    comm = phase("comm", comm_phase, dev)
    # launches on every path: serving and train (every model), speculation, load, checkpoint, the launcher
    runs = (serve, serve_m, serve_g, serve_c, serve_r, serve_q, *trains.values(), train_m2, spec, load, ckpt, comm)
    for r in records:
        r["launches"] = sum(run["launches"][r["name"]] for run in runs)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    shape_keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [dict({k: r[k] for k in keys}, shape=r["shape"],
                    other_shapes={n: {k: t.get(k) for k in shape_keys} for n, t in _sub_shapes(r).items()})
               for r in records]
    log("[time] " + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items()))
    news = ", ".join(
        f"{arch} train step {t['step_ms']:.1f} ms ({t['tokens_per_s']:.1f} tokens/s, peak "
        f"{t['peak_bytes'] / 2**30:.2f} GiB)" for arch, t in trains.items() if arch not in ("deepseek-7b",))
    log(f"[done] {smi}: build {build_s:.1f} s, model checks "
        + ", ".join(f"{e:.2e} ({a})" for a, e in model_errs.items())
        + f", train parity {parity}, train step {train['step_ms']:.1f} ms ({train['tokens_per_s']:.1f} tokens/s), "
        f"{news}, gemma-7b serving {serve_g['tok_per_s']:.1f} tok/s (peak {serve_g['peak_bytes'] / 2**30:.2f} GiB), "
        f"minicpm3-4b serving {serve_c['tok_per_s']:.1f} tok/s, recurrentgemma-9b serving "
        f"{serve_r['tok_per_s']:.1f} tok/s, qwen3-moe ({MOE_SERVE_LAYERS} layers) serving "
        f"{serve_q['tok_per_s']:.1f} tok/s, mamba2 train step {train_m2['step_ms']:.1f} ms "
        f"({train_m2['tokens_per_s']:.1f} tokens/s), examples {examples['seconds']:.1f} s, "
        f"self-draft accept rate {spec['self draft']['accept_rate']:.3f}, "
        f"load checksum {load['continuous']['output_checksum']}, checkpoint {ckpt['bytes']} bytes, "
        f"comm phase {comm['seconds']:.1f} s, "
        f"{time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
