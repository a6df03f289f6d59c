"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. header   — card name and power limit (nvidia-smi), torch and CUDA versions,
              the host's cost of a kernel launch into an idle and a busy card;
2. build    — builds the hand-written kernels from ``src/repro_torch/kernels/csrc``;
3. kernels  — the HGMMA count of the flash and ssd (forward and backward)
              kernels' SASS where ``cuobjdump`` is present (the bf16 routes
              have some, the wide (SIMT) routes none), the registers and spills of
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
              its limit; an unaligned input takes the wide route) and fp32
              (the wide route), run to
              run identical, autograd through the scan on a ragged L, and
              timed at the mamba2 train path's shape with both reckonings
              of its bound and its three kernels apart; the other
              families' shapes: flash both ways at minicpm3-4b's MLA (1,
              2048, 40, 96 / 64) and recurrentgemma-9b's windowed MQA
              ((1, 4096 / 2048, 16, 256), 1 KV head, window 2048), decode
              on its wrapped (8, 2048, 1, 256) ring (also against the
              model's own rule on the CPU), rmsnorm at widths 256 and 768;
              decode's partial route (a sequence-sharded cache's slice) on
              2 and 4 slices of (4, 2304, 32, 128) bf16 against its plain
              version (lse within 2e-5), combined against the whole-cache
              kernel, empty slices weight 0, run to run identical, timed;
              flash both ways at one rank's heads on a model axis of 2:
              qwen3-moe's (1, 2048, 32 on 2 KV heads, 128) and
              minicpm3-4b's MLA (1, 2048, 20, 96 / 64);
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
              minicpm3-4b (31 of its 62 layers, MLA: latent rows paged, decode in
              torch ops; ``[serve-minicpm3]``) and qwen3-moe-235b-a22b at
              full width cut to 8 layers (einsum dispatch; at decode the
              capacity 8 covers the 4 slots; ``[serve-moe]``); after the
              frontends, qwen1.5-110b (GQA 64 : 8, the QKV bias;
              ``[serve-qwen110b]``) and llama4-scout-17b-a16e (16 experts
              top-1 and a shared expert; ``[serve-llama4]``), each at full
              width cut to 8 layers;
6. serving  — full-width mamba2-130m (24 layers, bf16, seeded random init):
              prompts up to 4096 tokens, a sampled request and a duplicate
              (re-prefilled: ssm states are not paged); launch counts show the
              path ran through the ssd and rmsnorm kernels; a request admitted
              beside 7 decoding ones is held against prefill (its installed
              caches) and against the sequential loop (tokens, last logits
              and caches); then recurrentgemma-9b (38 layers: 12 local
              attention layers on a ring of the 2048 window, 26 RG-LRU
              layers; ``[serve-rgemma]``), the same requests and checks;
   frontends — hubert-xlarge at full width (48 layers, 16 heads of 80,
              bf16; ``[serve-hubert]``): the encoder forward and head over
              (2, 4096) seeded frame embeddings, every 4th frame masked,
              one non-causal flash call a layer (exact launch counts), run
              to run identical, wall / device ms, busy share, peak; then
              internvl2-2b (24 layers, 16 / 8 heads of 128;
              ``[serve-internvl]``): 4 sequences of 256 seeded patch
              embeddings + 1792 tokens prefilled together, ``prime_cache``
              at ``MAX_SEQ``, 16 greedy decode steps from position 2048
              (exact launch counts, the stream identical on a second run),
              prefill and decode wall / device ms, peak; each with a
              2-layer fp32 check within 1e-3 (hubert's logits against the
              CPU port; internvl's prefill and teacher-forced decode
              against the card's full forward and the CPU port);
7. model    — full width cut in depth, fp32: the card's logits against the
              CPU port's (plain versions) for a prompt and decode steps, for
              deepseek-7b (2 layers), mamba2-130m (4 layers), gemma-7b
              (2 layers: the wide routes at head dim 256), minicpm3-4b (2),
              recurrentgemma-9b (3), qwen3-moe-235b-a22b (1), and
              qwen1.5-110b and llama4-scout-17b-a16e (1 each, 128-token
              prompts: the QKV bias, GQA 8:1 at 64 heads, top-1 routing
              with a shared expert);
8. train    — parity: deepseek-7b at full width and 1 layer, fp32, one
              staged train step (B = 2, L = 128, 2 microbatches) with
              Adafactor and with AdamW on the card against the CPU port
              from the same state (loss, grad norm, parameters; exact
              launch counts); gemma-7b (1 layer, L = 128, one step),
              minicpm3-4b (1 layer, L = 256, two steps), recurrentgemma-9b
              (3 layers, L = 128, one step) and qwen3-moe (1 layer, L = 128,
              one step; its gradients held
              elementwise, its card optimizer fed the CPU's gradients) with
              Adafactor; hubert-xlarge (1 layer, 256 frames) and
              internvl2-2b (1 layer, 256 patches + 128 tokens) with their
              config's AdamW, two steps each;
9. train    — deepseek-7b at full width and depth (30 layers, bf16,
              Adafactor, remat "full", logits in chunks of 1024), global
              batch (2, 2048) in 2 microbatches, 4 staged steps: finite
              losses, the schedule, exact launch counts of the four train
              kernels, step time, tokens/s, model TFLOP/s, peak memory; one
              profiled step; a nonfinite step that leaves every bit as it
              was; then, at a quarter of their depth for the script's time
              limit, gemma-7b the same way at 7 of its 28 layers
              (``[train-gemma]``: no rollback), minicpm3-4b at 8 of its
              62 layers, recurrentgemma-9b at 6 of its 38 and qwen3-moe
              cut to 2 (3 steps each; model FLOPs over the active
              parameters); hubert-xlarge (12 of 48, ``[train-hubert]``)
              and internvl2-2b (6 of 24, ``[train-internvl]``) at (2,
              4096) with their config's AdamW
              (internvl: 256 patches + 3840 tokens, logits in 5 chunks of
              768; model FLOPs count each projection over the positions it
              multiplies, hubert's attention over every pair);
              qwen1.5-110b and llama4-scout-17b-a16e at 2 layers with
              Adafactor (``[train-qwen110b]``, ``[train-llama4]``);
10. train   — mamba2-130m: parity at full width and 2 layers in fp32 (B =
              2, L = 512, 2 microbatches, AdamW) against the CPU port, then
              the full 24 layers in bf16 (AdamW, remat "full"), global
              batch (8, 2048) in 2 microbatches, 4 staged steps: finite
              losses, exact ssd / ssd_bwd / rmsnorm / rmsnorm_bwd launch
              counts, step time, tokens/s, peak memory, one profiled step;
    remat   — ``[remat]``: deepseek-7b at full width cut to 8 layers (bf16,
              Adafactor, (2, 2048) in 2 microbatches) under
              ``remat="dots_saveable"`` against ``"full"``: each
              microbatch's loss and every gradient bit for bit, then 3
              staged steps a mode (full / dots_saveable / full): step ms,
              peak, exact launch counts;
11. spec    — full-width deepseek-7b again (seed 0) cut to 6 layers, the serving phase's
              geometry and requests through ``ServeEngine`` with
              speculative decoding at k = 4: the 1-layer shrunken draft,
              the same with two forced rollbacks, and the target as its own
              draft; every stream (the sampled one too) equals the plain
              engine's, the self draft's greedy accept rate is 1.0, launch
              counts are exact (draft feeds × draft layers + verify
              sub-steps × 6 decode attentions); accept rate, tokens a
              round, round wall ms, tokens/s beside the plain engine's and
              one profiled round's device busy share;
12. load    — ``run_load`` on the same model (8 requests at 2/s, prompts of
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
              parameter count at 6 of its 24 layers in float32 (0.17 GB a
              rank; ``COMM_LAYERS``), every result
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
              without the flag, the JSON, exact launch counts;
15. pipeline — ``runtime.pipeline`` at deepseek-7b's full width: 4 stages
              on 4 ``cuda`` worker threads, 4 microbatches of (1, 2048),
              the head the final norm and the chunked cross-entropy over
              the 102400 vocab, under 1F1B and FIFO: fp32 at 4 layers, then
              bf16 at 8 (remat off; 16 fit beside 4 microbatches' held
              activations); loss and every gradient against the port's
              monolithic autograd on the same weights and batch (within
              1e-5 / 2e-2 of each leaf's largest |gradient|), exact flash
              and rmsnorm launch counts both ways; wall ms, the bubble
              (``trace_metrics``), device busy share and peak memory;
16. chaos   — ``dist.chaos`` with groups and payloads on the card, 3 seeds
              x 20 iterations: ring all-reduce under link faults over a hub
              and over 3 and 2 socket ranks (bit-exact every iteration),
              a rank dying under the elastic loop, the serve engine
              (reduced deepseek-7b) under deadlines, cancels and
              preemptions (its invariants, exact flash / decode / rmsnorm
              launches); injected fault counts and seconds;
17. mesh    — ``launch.mesh`` / ``dist.sharding`` on ``torch.distributed``:
              a one-rank NCCL group on the card runs the axis= collectives
              and ``hierarchical_psum`` on a (1, 1) pod x data mesh (bit for
              bit, timed) and two data-parallel train steps of reduced
              deepseek-7b, bit for bit the off-mesh steps (exact launch
              counts); gloo rank processes (CPU tensors) run the
              collectives at 4 ranks on (2, 2) and the data-parallel step
              at 2 and 4 ranks against one process (within 1e-6), and
              record whether gloo takes CUDA tensors.  NCCL across cards
              needs more than one card;
18. tp      — the ``model`` mesh axis: two gloo rank processes share the
              card on a (data=1, model=2) mesh, every tensor on ``cuda:0``
              (gloo takes CUDA tensors: all_reduce, MAX too).  fp32:
              deepseek-7b at full width cut to 2 layers, 2 staged
              Adafactor steps on one seeded (2, 2048) batch in 2
              microbatches, against one off-mesh process on the card (loss
              and grad norm within 1e-5 relative, every weight's parts
              within 1e-5 of its max and the norm offsets' within 5e-7,
              replicated leaves and the Adafactor state
              the same bits on both ranks); bf16 at 2 layers, the same
              steps: each rank's step ms, peak, state bytes, and exact
              flash / rmsnorm launch counts (off-mesh's per layer, every
              flash call at the 16 local heads).  Then qwen3-moe at full
              width (128 experts top-8: 64 a rank, expert parallelism; 32
              of its 64 query heads on 2 of its 4 KV heads), fp32 at 1
              layer under the same limits plus its MoE metrics and every
              router call's ``top_i`` the same bits on both ranks, bf16
              at 1 layer timed (2.42 GB of expert weights a layer a
              rank).  The kernel phase holds the flash forward and
              backward at those (1, 2048, 16, 128) and (1, 2048, 32 on 2
              KV heads, 128).  The same ranks then run ``[tp-serve]``'s
              serving runs;
19. tp-serve — serving on that mesh, each config at full width cut to 4
              layers: 4 prompts (2048 / 777 / 100 / 321 tokens)
              prefilled and primed into 2304 rows, 16 greedy
              ``build_serve_step`` steps; deepseek-7b fp32 under
              ``kv_shard="seq"`` and ``"heads"``, qwen3-moe (expert
              parallelism) and minicpm3-4b (MLA's 20 heads a rank, its
              latent cache by rows) fp32 under ``"seq"`` (tokens equal one
              process's on the card, logits within 1e-5 of the row's
              largest); bf16 ``"seq"`` timed (ms a decode step, each
              rank's peak, the tokens' agreement with one process's;
              deepseek-7b's busy share and each collective of its step
              timed alone); exact launch counts (decode's partial route:
              layers x steps; MLA decodes in torch ops);
20. dryrun  — ``launch/dryrun.py``'s model (on ``meta``, on the CPU) of
              cells measured above: ``[train]``'s deepseek-7b, the two new
              configs' train cells, ``[tp]``'s bf16 cells and
              ``[tp-serve]``'s bf16 decode steps at (data 1, model 2):
              their argument bytes must equal the card's (each rank's);
              their peak, FLOPs and the terms live at the peak are logged
              beside the card's ``max_memory_allocated`` (less what was
              allocated before the run) and step time;
21. wide    — (run right after the kernel phase) ``[wide]``: the wide routes (``csrc/*_wide.cu``: head dims
              above 256, SSD P above 64, N above 128 and chunks above 256,
              bf16 off the tensor-core grid) against their plain versions
              in fp32 and bf16, run to run identical, each timed at its
              path's shape beside its bound (and SDPA for attention); then
              deepseek-7b with 8 heads of 512 (serving 4 prompts through
              ``ServeEngine`` at 8 of its 30 layers, one bf16 train step at
              2 layers) and mamba2-130m with SSD head dim 128, state 256,
              chunk 512 (serving 8 slots with prompts up to 4096, one train
              step at 4 layers), each with a 1-layer fp32 check (logits
              and one train step, card against the CPU port) and exact
              launch counts on the wide routes (none on the main routes'
              attention and ssd).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Needs one card; imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
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
# minicpm3-4b serves 31 of its 62 layers (full width): the script's time limit
MINICPM3_SERVE_LAYERS = 31
# qwen1.5-110b's and llama4-scout's depth cuts (full width): each serves 8
# layers (~27 and ~40 GB of bf16 weights) and trains 2 with Adafactor
NEW_SERVE_LAYERS, NEW_TRAIN_LAYERS = 8, 2
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
             (2048 * QWEN_HEADS, 128),
             # the frontends' rows: hubert-xlarge (1280) and internvl2-2b (2048) at a
             # 4096-position microbatch and at their serving calls (2 x 4096 frames,
             # 4 x 2048 positions), internvl's 4 decode rows
             (4096, 1280), (4096, 2048), (8192, 1280), (8192, 2048), (4, 2048))
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
    frontends = ((4096, 1280), (4096, 2048), (8192, 1280), (8192, 2048), (4, 2048))
    for T, D in ((2048, 4096), (4, 4096), (8, 768), (2048, 256), (2048, 768)) + frontends:
        sets = [(_randn(gen, (T, D), dtype, dev), _randn(gen, (D,), dtype, dev, 0.1)) for _ in range(4)]
        weights = [(x, (1.0 + s.float()).to(dtype)) for x, s in sets]
        bound, by = _bound(2 * T * D * 2 + D * 2, 4 * T * D, dtype)
        times[(T, D)] = dict(
            ms=time_ms(ops.rmsnorm, sets), plain_ms=time_ms(rmsnorm_ref, sets),
            library_ms=time_ms(lambda x, w: torch.nn.functional.rms_norm(x, (w.shape[0],), w, 1e-6), weights),
            bound_ms=bound, bound_by=by, key=(T, D),
        )
        t = times[(T, D)]
        log(f"[kernels] rmsnorm x ({T}, {D}) bf16: kernel {t['ms']:.4f} ms, F.rms_norm {t['library_ms']:.4f} ms "
            f"(kernel / library {t['ms'] / t['library_ms']:.2f}), plain {t['plain_ms']:.4f} ms, bound "
            f"{bound:.4f} ms ({by}, {bound / t['ms']:.1%} of it)")
    for T, D in ((2048, 256), (2048, 768)) + frontends:
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
        hubert=times[(4096, 1280)], internvl=times[(4096, 2048)], hubert_serve=times[(8192, 1280)],
        internvl_prefill=times[(8192, 2048)], internvl_decode=times[(4, 2048)],
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
    built library, the wide routes' included, by ``cuobjdump -sass``; None
    where the tool is missing."""
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
            m = re.search(r"(?<=\d)((?:flash|ssd)_(?:fwd|bwd|wide|chunk)_\w*?kernel)(?:I(\w*?)E+v)?", line)
            fn = (f"{m.group(1)}<{m.group(2)}>" if m.group(2) else m.group(1)) if m else None
            if fn:
                counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    return counts


def check_hgmma() -> dict | None:
    """The main (bf16) routes of flash and ssd (forward and backward) run
    on the tensor cores (HGMMA in their SASS); the wide routes (every f32
    call among them), the flash backward's D pass and the ssd backward's
    conversion and dcum passes do not."""
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
    for prefix in ("flash_wide_fwd_kernel", "flash_wide_dkdv_kernel", "flash_wide_dq_kernel", "ssd_wide_fwd_kernel",
                   "ssd_wide_dx_kernel", "ssd_wide_dbdc_kernel", "ssd_wide_scalars_kernel"):
        assert any(k.startswith(prefix) for k in simt), (prefix, counts)
    assert all(counts[k] > 0 for k in tc) and all(counts[k] == 0 for k in simt), counts
    return counts


# the kernels whose registers and spills the kernel phase prints
RESOURCE_KERNELS = ("flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel", "ssd_bwd_wgmma_kernel",
                    "flash_fwd_wgmma_kernel", "flash_bwd_dkdv_wgmma256_kernel", "flash_bwd_dq_wgmma256_kernel",
                    "flash_wide_fwd_kernel", "flash_wide_dkdv_kernel", "flash_wide_dq_kernel", "ssd_wide_fwd_kernel",
                    "ssd_wide_dx_kernel", "ssd_wide_dbdc_kernel", "ssd_wide_scalars_kernel", "decode_kernel")


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
# the frontends' paths: hubert-xlarge's non-causal attention over 4096 frames
# (16 heads of 80, padded to 128 in the kernels) and internvl2-2b's causal GQA
# over 256 patches + 3840 text tokens (16 heads on 8 KV heads of 128), each a
# microbatch of (2, 4096) in 2; their serving calls (hubert's encode of 2 x
# 4096 frames, internvl's prefill of 4 x 2048 positions); internvl's decode on
# its 4-sequence cache of MAX_SEQ rows at the serving phase's last position
# (256 + 1792 + 16 - 1)
HUBERT_FLASH = (1, 4096, 4096, 16, 16, 80, 80, False, None, 0)
INTERNVL_FLASH = (1, 4096, 4096, 16, 8, 128, 128, True, None, 0)
HUBERT_SERVE_FLASH = (2, 4096, 4096, 16, 16, 80, 80, False, None, 0)
INTERNVL_PREFILL_FLASH = (4, 2048, 2048, 16, 8, 128, 128, True, None, 0)
# deepseek-7b's heads on one rank of a model axis of 2 (the [tp] phase)
TP_FLASH = (1, 2048, 2048, 16, 16, 128, 128, True, None, 0)
# on one rank of a model axis of 2: qwen3-moe's 32 of 64 query heads on 2 of
# its 4 KV heads ([tp]'s train steps, [tp-serve]'s 2048-token prefill) and
# minicpm3-4b's 20 of 40 MLA heads ([tp-serve]'s prefill)
TP_MOE_FLASH = (1, 2048, 2048, 32, 2, 128, 128, True, None, 0)
TP_MLA_FLASH = (1, 2048, 2048, 20, 20, 96, 64, True, None, 0)
# qwen1.5-110b's and llama4-scout's prefill and train paths: 64 and 40 query
# heads on 8 KV heads of 128 (GQA 8:1 and 5:1), one 2048-token sequence
Q110_FLASH = (1, 2048, 2048, 64, 8, 128, 128, True, None, 0)
L4_FLASH = (1, 2048, 2048, 40, 8, 128, 128, True, None, 0)
Q110_HEADS, L4_HEADS, NEW_KV_HEADS = 64, 40, 8
IVL_DECODE_POS = [2063, 2063, 2063, 2063]
IVL_HEADS, IVL_KV_HEADS = 16, 8
# one rank's heads on a model axis of 2 ([tp]'s microbatch of 2048):
# recurrentgemma-9b's windowed MQA (8 of 16 heads on its 1 KV head of 256),
# hubert-xlarge's non-causal Dh 80 (8 of 16 heads), internvl2-2b's GQA 2:1 (8
# on 4) and mamba2-130m's ssd (12 of 24 heads of 64, B/C (1, 2048, 1, 128))
TP_RG_FLASH = (1, 2048, 2048, 8, 1, 256, 256, True, 2048, 0)
TP_HUBERT_FLASH = (1, 2048, 2048, 8, 8, 80, 80, False, None, 0)
TP_IVL_FLASH = (1, 2048, 2048, 8, 4, 128, 128, True, None, 0)
TP_SSD_HEADS = 12


def _window_mask(L: int, window, dev) -> torch.Tensor:
    """(L, L) bool: key j visible to query i (causal, within ``window``)."""
    i = torch.arange(L, device=dev)[:, None]
    j = torch.arange(L, device=dev)[None, :]
    return (j <= i) & (i - j < window)


def _flash_times(gen, dev, B, L, H, D, KH=None, Dv=None, window=None, causal=True) -> dict:
    """Kernel, plain and SDPA times of the bf16 forward (causal unless
    told) at (B, L, H, D) with KH key / value heads of value dim Dv
    (``window`` keys at most), the bound of the work this input needs (at
    the head dim D, not the kernels' padded one), and whether two runs give
    the same bits.  SDPA takes Dv != D as it is, GQA expanded and a window
    as an explicit mask."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    KH, Dv = KH or H, Dv or D
    dtype = torch.bfloat16
    kw = dict(causal=causal, window=window)
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
        lib = time_ms(lambda q, k, v: sdpa(q, k, v, is_causal=causal), lib_sets)
    pairs = _pairs(L, L, causal, window, 0)
    flops = 2 * B * H * (D + Dv) * pairs
    bound, by = _bound(B * L * (H * D + KH * D + KH * Dv + H * Dv) * 2, flops, dtype)
    label = f"({B}, {L}, {H}, {D}" + (f" / {Dv}" if Dv != D else "") + ")" + (f", KH {KH}" if KH != H else "") \
        + (f", window {window}" if window else "")
    mode = "causal" if causal else "non-causal"
    log(f"[kernels] flash at {label} bf16 {mode}: {flops / 1e9:.2f} GFLOP, kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s), SDPA {lib:.4f} ms (kernel / SDPA {ms / lib:.2f}), plain {plain:.4f} "
        f"ms, bound {bound:.4f} ms ({by}, {bound / ms:.1%} of it); run to run identical: {same}")
    assert same, f"flash at {label}: not deterministic"
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                shape=f"q/k/v {label} bf16 {mode}", key=(B, L, L, H, KH, D, Dv))


def check_flash(dev) -> dict:
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device=dev).manual_seed(2)
    # every case in bf16 (the tensor cores) and fp32 (the wide route)
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
        HUBERT_FLASH, INTERNVL_FLASH,  # the frontends' train microbatch, then their serving calls
        HUBERT_SERVE_FLASH, INTERNVL_PREFILL_FLASH,
        TP_FLASH,  # the tensor-parallel step's local heads
        Q110_FLASH, L4_FLASH,  # qwen1.5-110b's and llama4-scout's prefill
        TP_MOE_FLASH, TP_MLA_FLASH,  # qwen3-moe's and minicpm3-4b's local heads at model=2
        TP_RG_FLASH, TP_HUBERT_FLASH, TP_IVL_FLASH,  # recurrentgemma-9b's, hubert's, internvl's at model=2
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
              "qwen": _flash_times(gen, dev, 1, 2048, QWEN_HEADS, 128, KH=QWEN_KV_HEADS),
              "hubert": _flash_times(gen, dev, 1, 4096, 16, 80, causal=False),
              "internvl": _flash_times(gen, dev, 1, 4096, IVL_HEADS, 128, KH=IVL_KV_HEADS),
              "hubert_serve": _flash_times(gen, dev, 2, 4096, 16, 80, causal=False),
              "internvl_prefill": _flash_times(gen, dev, 4, 2048, IVL_HEADS, 128, KH=IVL_KV_HEADS),
              "tp": _flash_times(gen, dev, 1, 2048, 16, 128),
              "qwen110b": _flash_times(gen, dev, 1, 2048, Q110_HEADS, 128, KH=NEW_KV_HEADS),
              "llama4": _flash_times(gen, dev, 1, 2048, L4_HEADS, 128, KH=NEW_KV_HEADS),
              "tp_moe": _flash_times(gen, dev, 1, 2048, 32, 128, KH=2),
              "tp_mla": _flash_times(gen, dev, 1, 2048, 20, 96, Dv=64),
              "tp_rgemma": _flash_times(gen, dev, 1, 2048, 8, 256, KH=1, window=2048),
              "tp_hubert": _flash_times(gen, dev, 1, 2048, 8, 80, causal=False)}
    shapes["tp_rgemma"]["max_abs_err"] = errs[TP_RG_FLASH]
    shapes["tp_hubert"]["max_abs_err"] = errs[TP_HUBERT_FLASH]
    shapes["tp"]["max_abs_err"] = errs[TP_FLASH]
    shapes["tp_moe"]["max_abs_err"] = errs[TP_MOE_FLASH]
    shapes["tp_mla"]["max_abs_err"] = errs[TP_MLA_FLASH]
    shapes["qwen110b"]["max_abs_err"] = errs[Q110_FLASH]
    shapes["llama4"]["max_abs_err"] = errs[L4_FLASH]
    shapes["d256"]["max_abs_err"] = err256
    shapes["mla"]["max_abs_err"] = errs[MLA_FLASH]
    shapes["rgemma"]["max_abs_err"] = errs[RG_FLASH]
    shapes["qwen"]["max_abs_err"] = errs[QWEN_FLASH]
    shapes["hubert"]["max_abs_err"] = errs[HUBERT_FLASH]
    shapes["internvl"]["max_abs_err"] = errs[INTERNVL_FLASH]
    shapes["hubert_serve"]["max_abs_err"] = errs[HUBERT_SERVE_FLASH]
    shapes["internvl_prefill"]["max_abs_err"] = errs[INTERNVL_PREFILL_FLASH]
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
                shape=f"q ({B}, 1, {H}, {D}), cache ({B}, {S}, {KH}, {D}) bf16, pos {pos_l}",
                key=(B, S, H, KH, D, D))


TPS_SLICES = (2, 4)  # the partial route's slice counts (the [tp-serve] cache is split in 2)
LSE_ATOL = 2e-5  # the partial route's log-sum-exp against the plain one's (float32, natural log)


def _decode_partial(dev, gen, main_pos) -> dict:
    """The partial route (a sequence-sharded cache's slice) at (4, 2304,
    32, 128) bf16, the cache split into 2 and 4 slices at the path's
    positions and at positions that leave slices empty: each slice against
    the plain version (output within the bf16 tolerance, lse within
    ``LSE_ATOL``), run to run identical, an empty slice's lse -inf and
    output 0 (weight 0 in the combine); the slices combined
    (``combine_partials``) within the bf16 tolerance of the whole-cache
    kernel's output.  Then the time of the 2-slice split's slices (the
    [tp-serve] ranks' calls) beside the bound of the bytes of each slice's
    valid rows."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    B, S, H, D, dtype = N_SLOTS, MAX_SEQ, 32, 128, torch.bfloat16
    q = _randn(gen, (B, 1, H, D), dtype, dev)
    k, v = (_randn(gen, (B, S, H, D), dtype, dev) for _ in range(2))
    err = 0.0
    for pos_l in (main_pos, [S - 1, 100, S // 4 - 1, S // 2]):
        pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
        whole = ops.decode_attention(q, k, v, pos)
        for n in TPS_SLICES:
            Sl, outs, lses = S // n, [], []
            for i in range(n):
                ks, vs = k[:, i * Sl:(i + 1) * Sl], v[:, i * Sl:(i + 1) * Sl]
                out, lse = ops.decode_attention(q, ks, vs, pos, i * Sl, partial=True)
                again = ops.decode_attention(q, ks, vs, pos, i * Sl, partial=True)
                assert torch.equal(again[0], out) and torch.equal(again[1], lse), \
                    f"decode partial slice {i} of {n}: not deterministic"
                ref_out, ref_lse = decode_attention_ref(q, ks, vs, pos, i * Sl, partial=True)
                empty = pos < i * Sl  # the slice holds no valid slot of these sequences
                assert torch.equal(torch.isinf(lse), empty[:, None].expand(B, H)), f"slice {i} of {n}: lse -inf"
                assert not out[empty].any(), f"slice {i} of {n}: an empty slice's output is not 0"
                live = ~empty
                if live.any():
                    err = max(err, _compare(f"decode partial slice {i} of {n} at {pos_l}", out[live], ref_out[live],
                                            dtype))
                    lse_err = float((lse[live] - ref_lse[live]).abs().max())
                    assert lse_err <= LSE_ATOL, f"slice {i} of {n}: lse {lse_err:.2e} from the plain one's"
                    log(f"[kernels] decode partial slice {i} of {n} at {pos_l}: lse within {lse_err:.2e} of the "
                        f"plain one's (limit {LSE_ATOL}); run to run identical; empty for {int(empty.sum())} of {B}")
                outs.append(out)
                lses.append(lse)
            combined = ops.combine_partials(torch.stack(outs), torch.stack(lses)).to(dtype)
            _compare(f"decode partial, {n} slices combined at {pos_l}, against the whole-cache kernel", combined,
                     whole, dtype)
    # times: the 2-slice split at the path's positions, each slice as its rank calls it
    pos = torch.tensor(main_pos, dtype=torch.int32, device=dev)
    Sl = S // 2
    sets = [[(_randn(gen, (B, 1, H, D), dtype, dev), _randn(gen, (B, Sl, H, D), dtype, dev),
              _randn(gen, (B, Sl, H, D), dtype, dev), pos) for _ in range(2)] for _ in range(2)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    slices = []
    for i in range(2):
        ms = time_ms(lambda q, k, v, p, i=i: ops.decode_attention(q, k, v, p, i * Sl, partial=True), sets[i])
        plain = time_ms(lambda q, k, v, p, i=i: decode_attention_ref(q, k, v, p, i * Sl, partial=True), sets[i])
        valid = (torch.arange(Sl, device=dev)[None, :] < (pos + 1 - i * Sl)[:, None])[:, None, None, :]
        lib_sets = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), p) for q, k, v, p in sets[i]]
        lib = time_ms(lambda q, k, v, p: sdpa(q, k, v, attn_mask=valid), lib_sets)
        n_valid = sum(max(0, min(p + 1 - i * Sl, Sl)) for p in main_pos)
        bytes_moved = B * H * D * 2 + 2 * n_valid * H * D * 2 + B * H * (D + 1) * 4 + B * 4
        bound, by = _bound(bytes_moved, 4 * n_valid * H * D, dtype)
        log(f"[kernels] decode partial slice {i} of 2 (cache ({B}, {Sl}, {H}, {D}) from slot {i * Sl}, {n_valid} "
            f"valid rows) at pos {main_pos}: kernel {ms:.4f} ms, masked SDPA (output only) {lib:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bound:.5f} ms ({by}, {bound / ms:.1%} of it)")
        slices.append(dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by, n_valid=n_valid))
    first = slices[0]
    return dict(first, max_abs_err=err, slices=slices,
                shape=f"partial route: q ({B}, 1, {H}, {D}), cache slice ({B}, {Sl}, {H}, {D}) from slot 0 of "
                      f"{S} bf16, pos {main_pos}",
                key=(B, Sl, H, H, D, D, "partial"))


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
        # internvl2-2b's: 16 query heads on 8 KV heads of 128, past its 256 patch rows
        (N_SLOTS, MAX_SEQ, IVL_HEADS, IVL_KV_HEADS, 128, IVL_DECODE_POS, (torch.bfloat16, torch.float32)),
        # qwen1.5-110b's and llama4-scout's: 64 and 40 query heads on 8 KV heads of 128
        (N_SLOTS, MAX_SEQ, Q110_HEADS, NEW_KV_HEADS, 128, main_pos, (torch.bfloat16, torch.float32)),
        (N_SLOTS, MAX_SEQ, L4_HEADS, NEW_KV_HEADS, 128, main_pos, (torch.bfloat16, torch.float32)),
    ]
    err = err256 = 0.0
    errs = {}
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
            if dtype == torch.bfloat16:
                errs[(H, KH, D)] = e
            if S == MAX_SEQ and dtype == torch.bfloat16 and (H, KH) in ((32, 32), (G_HEADS, G_HEADS)):
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
            if (H, KH) == (QWEN_HEADS, QWEN_KV_HEADS) and dtype == torch.bfloat16:
                err_qwen = e
            if (H, KH) == (IVL_HEADS, IVL_KV_HEADS) and dtype == torch.bfloat16:
                err_ivl = e
    # run to run identical, and batch-invariant: each sequence beside empty
    # slots (positions 0) equals itself beside the live ones, bit for bit;
    # deepseek-7b's heads (and GQA), then gemma-7b's, then qwen3-moe's
    B, S, dtype = N_SLOTS, MAX_SEQ, torch.bfloat16
    for H, KH, D in ((32, 32, 128), (32, 8, 128), (G_HEADS, G_HEADS, G_DIM), (G_HEADS, 4, G_DIM),
                     (QWEN_HEADS, QWEN_KV_HEADS, 128), (IVL_HEADS, IVL_KV_HEADS, 128),
                     (Q110_HEADS, NEW_KV_HEADS, 128), (L4_HEADS, NEW_KV_HEADS, 128)):
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
    ivl = _decode_times(gen, dev, IVL_HEADS, 128, IVL_DECODE_POS, KH=IVL_KV_HEADS)
    ivl["max_abs_err"] = err_ivl
    q110 = _decode_times(gen, dev, Q110_HEADS, 128, main_pos, KH=NEW_KV_HEADS)
    q110["max_abs_err"] = errs[(Q110_HEADS, NEW_KV_HEADS, 128)]
    l4 = _decode_times(gen, dev, L4_HEADS, 128, main_pos, KH=NEW_KV_HEADS)
    l4["max_abs_err"] = errs[(L4_HEADS, NEW_KV_HEADS, 128)]
    partial = _decode_partial(dev, gen, main_pos)
    return dict(
        name="decode_attention", route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:81", max_abs_err=err, **main,
        short=short, d256=d256, rgemma=ring, qwen=qwen, internvl=ivl, qwen110b=q110, llama4=l4,
        tpserve_partial=partial, tpserve_ring=_decode_ring_partial(dev, gen),
    )


def _decode_ring_partial(dev, gen) -> dict:
    """The partial route on recurrentgemma-9b's ring split over a model axis
    of 2 ([tp-serve]'s cache: 8 slots, 1024 of the 2048 ring slots a rank,
    16 heads on 1 KV head of 256) at its last positions, all wrapped but
    one: each slice against the plain version (output within the bf16
    tolerance, lse within ``LSE_ATOL``), the two combined against the whole
    ring's kernel output; then slice 0's time (and slice 1's logged)
    beside the bound of its bytes."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    B, S, H, KH, D, dtype = len(TPS_REC_PROMPTS), RG_RING, 16, 1, 256, torch.bfloat16
    pos_l = [p + TPS_STEPS - 1 for p in TPS_REC_PROMPTS]
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    Sl, err, rows = S // 2, 0.0, []
    sets = [(_randn(gen, (B, 1, H, D), dtype, dev), _randn(gen, (B, S, KH, D), dtype, dev),
             _randn(gen, (B, S, KH, D), dtype, dev)) for _ in range(2)]
    q, k, v = sets[0]
    outs, lses = [], []
    for i in range(2):
        ks, vs = k[:, i * Sl:(i + 1) * Sl], v[:, i * Sl:(i + 1) * Sl]
        out, lse = ops.decode_attention(q, ks, vs, pos, i * Sl, partial=True)
        ref_out, ref_lse = decode_attention_ref(q, ks, vs, pos, i * Sl, partial=True)
        err = max(err, _compare(f"decode partial ring slice {i} of 2 at {pos_l}", out, ref_out, dtype))
        empty = pos < i * Sl  # short sequences hold no slot of the second half
        assert torch.equal(torch.isinf(lse), empty[:, None].expand(B, H)), f"ring slice {i}: lse -inf"
        lse_err = float((lse[~empty] - ref_lse[~empty]).abs().max())
        assert lse_err <= LSE_ATOL, f"ring slice {i}: lse {lse_err:.2e} from the plain one's"
        outs.append(out)
        lses.append(lse)
    combined = ops.combine_partials(torch.stack(outs), torch.stack(lses)).to(dtype)
    _compare(f"decode partial ring, 2 slices combined at {pos_l}, against the whole ring's kernel", combined,
             ops.decode_attention(q, k, v, pos), dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for i in range(2):
        sl = [(q, k[:, i * Sl:(i + 1) * Sl].contiguous(), v[:, i * Sl:(i + 1) * Sl].contiguous(), pos)
              for q, k, v in sets]
        ms = time_ms(lambda q, k, v, p, i=i: ops.decode_attention(q, k, v, p, i * Sl, partial=True), sl)
        plain = time_ms(lambda q, k, v, p, i=i: decode_attention_ref(q, k, v, p, i * Sl, partial=True), sl)
        n_valid_b = [max(0, min(p + 1 - i * Sl, Sl)) for p in pos_l]
        valid = (torch.arange(Sl, device=dev)[None, :] < torch.tensor(n_valid_b, device=dev)[:, None])[:, None, None, :]
        lib_sets = [(q.transpose(1, 2), k.transpose(1, 2).expand(-1, H, -1, -1), v.transpose(1, 2).expand(-1, H, -1, -1),
                     p) for q, k, v, p in sl]
        lib = time_ms(lambda q, k, v, p: sdpa(q, k, v, attn_mask=valid), lib_sets)
        n_valid = sum(n_valid_b)
        bytes_moved = B * H * D * 2 + 2 * n_valid * KH * D * 2 + B * H * (D + 1) * 4 + B * 4
        bound, by = _bound(bytes_moved, 4 * n_valid * H * D, dtype)
        log(f"[kernels] decode partial ring slice {i} of 2 (cache ({B}, {Sl}, {KH}, {D}) from slot {i * Sl} of "
            f"{S}, {H} heads, {n_valid} valid rows) at pos {pos_l}: kernel {ms:.4f} ms, masked SDPA (output only) "
            f"{lib:.4f} ms, plain {plain:.4f} ms, bound {bound:.5f} ms ({by}, {bound / ms:.1%} of it)")
        rows.append(dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by))
    return dict(rows[0], max_abs_err=err, slices=rows,
                shape=f"partial route on a wrapped ring: q ({B}, 1, {H}, {D}), slice ({B}, {Sl}, {KH}, {D}) from "
                      f"slot 0 of {S} bf16, pos {pos_l}",
                key=(B, Sl, H, KH, D, D, "partial"))


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
    # one group per head; bf16 runs on the tensor cores, f32 on the wide route
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
    # one rank's heads on a model axis of 2 ([tp]'s mamba2-130m microbatch)
    tp_H = TP_SSD_HEADS
    sets = [_ssd_chunk_args(*_ssd_inputs(gen, dev, dtype, L, tp_H, P, N, 1), cs) for _ in range(4)]
    (y, st), (y0, st0) = ops.ssd_intra_chunk(*sets[0]), ssd_chunk_ref(*sets[0])
    tp_err = _compare_ssd(f"ssd y at one rank's {tp_H} heads", y, y0)
    _compare_ssd(f"ssd state at one rank's {tp_H} heads", st, st0)
    n_tp = tp_H * (L // cs)
    tp_tc = n_tp * (2 * pairs * N + 2 * (2 * pairs * P + 2 * cs * N * P))
    tp_bytes = (L * tp_H * P + 2 * L * N) * 2 + 2 * L * tp_H * 4 + (L * tp_H * P + n_tp * N * P) * 4
    tp_bound, tp_by = _bound(tp_bytes, tp_tc, dtype)
    tp_ms, tp_plain = time_ms(ops.ssd_intra_chunk, sets), time_ms(ssd_chunk_ref, sets)
    log(f"[kernels] ssd at one rank's {tp_H} of 24 heads: kernel {tp_ms:.4f} ms, plain {tp_plain:.4f} ms, bound "
        f"{tp_bound:.5f} ms ({tp_by}, {tp_bound / tp_ms:.1%} of it)")
    tp_heads = dict(ms=tp_ms, plain_ms=tp_plain, library_ms=None, bound_ms=tp_bound, bound_by=tp_by,
                    max_abs_err=tp_err, shape=f"x (1, {L}, {tp_H}, {P}), B/C (1, {L}, 1, {N}) bf16, cs {cs}",
                    key=(1, tp_H, L // cs, cs, P, 1, N))
    return dict(
        name="ssd", route="cuda", source="src/repro_torch/kernels/csrc/ssd.cu",
        replaces="src/repro/kernels/ssd/kernel.py:58", max_abs_err=err, ms=ms, tp_heads=tp_heads,
        plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=None, old_bound_ms=old_bound,
        shape=(f"x (1, {L}, {H}, {P}), B/C (1, {L}, 1, {N}) bf16, cs {cs}; "
               f"{(score_flops + f32_flops) / 1e9:.2f} GFLOP ({tc_flops / 1e9:.2f} on the tensor cores)"),
    )


TRACE_PAD_S = 0.02  # the card idle at either end of a torch.profiler window


@contextlib.contextmanager
def device_trace(cpu: bool = True):
    """``torch.profiler`` (CUDA, and CPU unless told) over the body, the
    card idle for ``TRACE_PAD_S`` at either end of the window: a trace was
    seen to drop the kernels that ran at its window's start."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)


def backward_ms(forward, leaves, grad, iters: int = 10) -> float:
    """Device time of one autograd backward of ``forward(*leaves)`` (a
    library op's) against ``grad``, as :func:`time_ms` takes it: ``iters``
    backward calls captured into a CUDA graph, replayed between two CUDA
    events.  The leaves are made anew and the forward run on the capture
    stream, so that the backward's nodes run on it too."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        leaves = [t.detach().requires_grad_() for t in leaves]
        out = forward(*leaves)
        torch.autograd.grad(out, leaves, grad, retain_graph=True)  # warm up outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            torch.autograd.grad(out, leaves, grad, retain_graph=True)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_calls(fn, iters: int = 10, tries: int = 3) -> dict | None:
    """Device time of one call of ``fn`` by kernel (``top``, to split a
    call into its kernels): ``_device_rows`` of ``iters`` calls under
    ``torch.profiler``, warmed up first.

    Every call runs the same kernels, so a whole trace holds a whole
    multiple of ``iters`` kernel runs, at least one a call.  A trace that
    lost some is taken again, up to ``tries`` times; then the split is not
    measured (None), so a trace that lost kernels never gives a number."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with device_trace() as prof:
            for _ in range(iters):
                fn()
        kernels = {ev.key: ev.count for ev in prof.key_averages()
                   if getattr(ev, "device_time_total", 0.0) and ev.device_type.name == "CUDA"
                   and not ev.key.startswith(("Memset", "Memcpy"))}
        n = sum(kernels.values())
        if n >= iters and n % iters == 0:
            return _device_rows(prof, 0.0, iters)
        log(f"[kernels] trace {attempt} of {tries}: torch.profiler saw {n} kernel runs in {iters} identical "
            f"calls (not a whole multiple, at least one a call): {kernels}")
    return None


# backward outputs are float32 sums over a sequence (dK, dV over queries, dQ
# over keys; dscale over rows), whatever the dtype, so their rounding error
# scales with the output's magnitude: atol·max|plain| + rtol·|plain|
BWD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


def _compare_bwd(name, got, want, dtype) -> float:
    scale = float(want.float().abs().max())
    atol, rtol = BWD_TOL[dtype]
    return _compare(f"{name} (max|plain| {scale:.3e})", got, want, None,
                    dict(atol=atol * scale, rtol=rtol))


def _flash_bwd_times(gen, dev, B, L, H, D, KH=None, Dv=None, window=None, causal=True) -> dict:
    """The bf16 backward (causal unless told) at (B, L, H, D) with KH key /
    value heads of value dim Dv (``window`` keys at most): kernel, plain
    and SDPA backward times, the dK/dV and dQ kernels apart, the forward
    with and without lse, and the bound of the 5 products the unmasked
    pairs need (at the head dim D, not the kernels' padded one)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    KH, Dv = KH or H, Dv or D
    dtype = torch.bfloat16
    kw = dict(causal=causal, window=window)
    sets = []
    for _ in range(2):
        q, k = _randn(gen, (B, L, H, D), dtype, dev), _randn(gen, (B, L, KH, D), dtype, dev)
        v, do = _randn(gen, (B, L, KH, Dv), dtype, dev), _randn(gen, (B, L, H, Dv), dtype, dev)
        out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
        sets.append((q, k, v, out, lse, do))
    ms = time_ms(lambda *a: ops.flash_attention_bwd(*a, **kw), sets)
    split = profiled_calls(lambda: ops.flash_attention_bwd(*sets[0], **kw))
    plain = time_ms(lambda *a: attention_bwd_ref(*a, **kw), sets[:1], iters=3)
    # the serving forward (lse not asked for) against the train forward
    fwd_sets = [s[:3] for s in sets]
    fwd_ms = time_ms(lambda q, k, v: ops.flash_attention(q, k, v, **kw), fwd_sets)
    fwd_lse_ms = time_ms(lambda q, k, v: ops.flash_attention(q, k, v, return_lse=True, **kw), fwd_sets)
    # PyTorch's call: the backward of SDPA alone (its forward built once;
    # GQA expanded, a window shorter than L as an explicit mask)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    heads = lambda t: t.transpose(1, 2).repeat_interleave(H // KH, dim=1) if KH != H else t.transpose(1, 2)  # noqa: E731
    leaves = [sets[0][0].transpose(1, 2), *(heads(t) for t in sets[0][1:3])]
    if window is not None and window < L:
        mask = _window_mask(L, window, dev)
        lib = backward_ms(lambda q, k, v: sdpa(q, k, v, attn_mask=mask), leaves, sets[0][5].transpose(1, 2))
    else:
        lib = backward_ms(lambda q, k, v: sdpa(q, k, v, is_causal=causal), leaves, sets[0][5].transpose(1, 2))
    pairs = _pairs(L, L, causal, window, 0)
    # 5 products over the unmasked pairs (the kernels run 7): S and dQ, dK
    # at D; dP and dV at Dv
    flops = 2 * B * H * (3 * D + 2 * Dv) * pairs
    # q, k, v, out, dout read, dq, dk, dv written, lse read
    bound, by = _bound(2 * B * L * (2 * H * D + 2 * KH * D + 2 * KH * Dv + 2 * H * Dv) + B * H * L * 4, flops,
                       dtype)
    label = f"({B}, {L}, {H}, {D}" + (f" / {Dv}" if Dv != D else "") + ")" + (f", KH {KH}" if KH != H else "") \
        + (f", window {window}" if window else "")
    Dh, D = D, f"{D} / {Dv}" if Dv != D else D
    mode = "causal" if causal else "non-causal"
    log(f"[kernels] flash bwd at {label} bf16 {mode}: {flops / 1e9:.2f} GFLOP, kernel "
        f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), SDPA backward {lib:.4f} ms (kernel / library "
        f"{ms / lib:.2f}), plain {plain:.4f} ms, bound {bound:.4f} ms ({by}, {bound / ms:.1%} of it)")
    # the dK/dV and dQ kernels apart: dK/dV runs 4 of the 7 products, dQ 3
    if split is None:
        dkdv = dq = dot = None
        log(f"[kernels] flash bwd kernels apart at head dim {D}: not measured (every trace lost kernels)")
    else:
        parts = dict(split["top"])
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
                shape=f"q/k/v/out/dout {label} bf16 {mode}", key=(B, L, L, H, KH, Dh, Dv))


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
        # padded to 256 (the role-split bf16 kernels):
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
        HUBERT_FLASH, INTERNVL_FLASH,  # the frontends', at (2, 4096) in 2 microbatches
        TP_FLASH,  # deepseek-7b's local heads at model=2
        Q110_FLASH, L4_FLASH,  # qwen1.5-110b's and llama4-scout's, at (2, 2048) in 2 microbatches
        TP_MOE_FLASH, TP_MLA_FLASH,  # qwen3-moe's and minicpm3-4b's local heads at model=2
        TP_RG_FLASH, TP_HUBERT_FLASH, TP_IVL_FLASH,  # recurrentgemma-9b's, hubert's, internvl's at model=2
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
              "qwen": _flash_bwd_times(gen, dev, 1, 2048, QWEN_HEADS, 128, KH=QWEN_KV_HEADS),
              "hubert": _flash_bwd_times(gen, dev, 1, 4096, 16, 80, causal=False),
              "internvl": _flash_bwd_times(gen, dev, 1, 4096, IVL_HEADS, 128, KH=IVL_KV_HEADS),
              "tp": _flash_bwd_times(gen, dev, 1, 2048, 16, 128),
              "qwen110b": _flash_bwd_times(gen, dev, 1, 2048, Q110_HEADS, 128, KH=NEW_KV_HEADS),
              "llama4": _flash_bwd_times(gen, dev, 1, 2048, L4_HEADS, 128, KH=NEW_KV_HEADS),
              "tp_moe": _flash_bwd_times(gen, dev, 1, 2048, 32, 128, KH=2),
              # MLA's local heads: timed, not on a path here ([tp] trains no MLA model)
              "mla_tp": _flash_bwd_times(gen, dev, 1, 2048, 20, 96, Dv=64),
              "tp_rgemma": _flash_bwd_times(gen, dev, 1, 2048, 8, 256, KH=1, window=2048),
              "tp_hubert": _flash_bwd_times(gen, dev, 1, 2048, 8, 80, causal=False)}
    shapes["tp_rgemma"]["max_abs_err"] = errs[TP_RG_FLASH]
    shapes["tp_hubert"]["max_abs_err"] = errs[TP_HUBERT_FLASH]
    shapes["tp"]["max_abs_err"] = errs[TP_FLASH]
    shapes["tp_moe"]["max_abs_err"] = errs[TP_MOE_FLASH]
    shapes["mla_tp"]["max_abs_err"] = errs[TP_MLA_FLASH]
    shapes["qwen110b"]["max_abs_err"] = errs[Q110_FLASH]
    shapes["llama4"]["max_abs_err"] = errs[L4_FLASH]
    shapes["d256"]["max_abs_err"] = err256
    shapes["mla"]["max_abs_err"] = errs[MLA_FLASH]
    shapes["rgemma"]["max_abs_err"] = errs[RG_FLASH_BWD]
    shapes["qwen"]["max_abs_err"] = errs[QWEN_FLASH]
    shapes["hubert"]["max_abs_err"] = errs[HUBERT_FLASH]
    shapes["internvl"]["max_abs_err"] = errs[INTERNVL_FLASH]
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
             (2048, 256), (2048, 768), (2048 * QWEN_HEADS, 128), (4096, 1280), (4096, 2048))
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
    x, s, dy = sets[0]
    lib = backward_ms(lambda x, w: torch.nn.functional.rms_norm(x, (D,), w, 1e-6),
                      [x, (1.0 + s.float()).to(dtype)], dy)
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


def _ssd_bwd_args(gen, dev, dtype, b, L, H, G, cs, dt_shift=-1.0, P=64, N=128):
    """``_ssd_chunk_args`` of a (b, L) batch (mamba2's P = 64, N = 128
    unless told), and float32 cotangents of y (the permuted view of the
    model's (b, nc, cs, H, P) order that autograd hands the backward) and
    of the state."""
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
    output's worst share of its limit logged) and fp32 (the wide route), run to run
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
    # an unaligned bf16 input (x one element into its buffer): the tensor-core
    # route does not take it, the wide route does (none launched here)
    (x, *rest), dy, dS = _ssd_bwd_args(gen, dev, torch.bfloat16, 1, 512, 4, 1, 256)
    shifted = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view(x.shape).copy_(x)
    before, wide_before = ops.bwd_launches.count, ops.wide_bwd_launches.count
    for name, g, w in zip(("dx", "ddt", "dcum", "dB", "dC"), ops.ssd_intra_chunk_bwd(shifted, *rest, dy, dS),
                          ssd_chunk_bwd_ref(shifted, *rest, dy, dS)):
        _compare_bwd(f"ssd bwd {name} unaligned bf16 x (the wide route)", g, w, torch.bfloat16)
    assert ops.bwd_launches.count == before and ops.wide_bwd_launches.count == wide_before + 1
    log("[kernels] ssd bwd unaligned bf16 x: the wide route took it, none launched on the tensor-core route")
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
    split = profiled_calls(lambda: ops.ssd_intra_chunk_bwd(*sets[0]))
    if split is None:
        log("[kernels] ssd bwd kernels apart: not measured (every trace lost kernels)")
    else:
        parts = dict(split["top"])
        log("[kernels] ssd bwd kernels apart (profiler, 10 calls): "
            + ", ".join(f"{n[:70]} {t:.4f} ms" for n, t in parts.items()))
        main_ms = sum(t for n, t in parts.items() if "wgmma" in n)
        cvt_ms = sum(t for n, t in parts.items() if "cvt" in n)
        dcum_ms = sum(t for n, t in parts.items() if "dcum" in n)
        cvt_bytes = b * L * H * P * (4 + 2) + n_chunks * N * P * (4 + 2)
        log(f"[kernels] ssd bwd apart: wgmma kernel {main_ms:.4f} ms ({flops / main_ms / 1e9:.1f} TFLOP/s of "
            f"the needed work), dy / dS conversion {cvt_ms:.4f} ms ({cvt_bytes} bytes, "
            f"{cvt_bytes / cvt_ms / 1e9:.3f} TB/s), dcum pass {dcum_ms:.4f} ms")
    # one rank's heads on a model axis of 2 ([tp]'s mamba2-130m microbatch)
    tp_b, tp_H = 1, TP_SSD_HEADS
    sets = [_ssd_bwd_args(gen, dev, dtype, tp_b, L, tp_H, G, cs) for _ in range(2)]
    sets = [(*args, dy, dS) for args, dy, dS in sets]
    got, want = ops.ssd_intra_chunk_bwd(*sets[0]), ssd_chunk_bwd_ref(*sets[0])
    tp_err = [_compare_bwd(f"ssd bwd {name} at one rank's {tp_H} heads", g, w, dtype)
              for name, g, w in zip(("dx", "ddt", "dcum", "dB", "dC"), got, want)][0]  # dx's, as the main row's
    del got, want
    n_tp = tp_b * tp_H * nc
    tp_flops = n_tp * (2 * pairs * (3 * N + 2 * P) + 4 * cs * N * P)
    tp_bytes = (tp_b * L * tp_H * P * el + 2 * tp_b * L * G * N * el
                + tp_b * L * tp_H * P * 4 + n_tp * N * P * 4 + 2 * tp_b * L * tp_H * 4
                + tp_b * L * tp_H * P * el + 2 * tp_b * L * tp_H * 4 + 2 * tp_b * L * G * N * el)
    tp_bound, tp_by = _bound(tp_bytes, tp_flops, dtype)
    tp_ms, tp_plain = time_ms(ops.ssd_intra_chunk_bwd, sets), time_ms(ssd_chunk_bwd_ref, sets[:1], iters=3)
    log(f"[kernels] ssd bwd at one rank's {tp_H} of 24 heads: kernel {tp_ms:.4f} ms, plain {tp_plain:.4f} ms, bound "
        f"{tp_bound:.5f} ms ({tp_by}, {tp_bound / tp_ms:.1%} of it)")
    tp_heads = dict(ms=tp_ms, plain_ms=tp_plain, library_ms=None, bound_ms=tp_bound, bound_by=tp_by,
                    max_abs_err=tp_err,
                    shape=f"x ({tp_b}, {L}, {tp_H}, {P}), B/C ({tp_b}, {L}, {G}, {N}) bf16, cs {cs}",
                    key=(tp_b, tp_H, nc, cs, P, G, N))
    return dict(
        name="ssd_bwd", route="cuda", source="src/repro_torch/kernels/csrc/ssd_bwd_wgmma.cu", tp_heads=tp_heads,
        replaces="src/repro/models/ssm.py:74 (no Pallas kernel: JAX differentiates the jnp ssd_chunked)",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=None,
        simt_ms=t_simt, flops=flops, bytes=bytes_moved,
        shape=f"x ({b}, {L}, {H}, {P}), B/C ({b}, {L}, {G}, {N}) bf16, cs {cs}; {flops / 1e9:.2f} GFLOP",
    )


def _sub_shapes(record: dict) -> dict:
    """A kernel record's other timed shapes (the Dh 256, MLA, ring, ...
    paths), each a dict with its own ``shape`` and times."""
    return {k: v for k, v in record.items() if isinstance(v, dict) and "ms" in v and "shape" in v}


def _frontend_shape_launches(records: list, paths: dict) -> None:
    """Each frontend shape's row (``hubert*`` / ``internvl*``) gets its
    launches at that very shape on its family's ``paths`` (serving and
    training runs, each holding ``launches_by_shape``); every such row must
    have been launched there."""
    for r in records:
        for sub, t in _sub_shapes(r).items():
            family = sub.split("_")[0]
            if family in paths:
                t["launches"] = sum(p["launches_by_shape"].get(r["name"], {}).get(t["key"], 0)
                                    for p in paths[family])
                assert t["launches"] > 0, f"{r['name']} at {t['shape']}: no launch at that shape on {family}'s paths"


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
    """Each kernel's launch counter, by the name its record carries: the
    main routes' (``flash_attention``, ...) and the wide routes'
    (``flash_attention_wide``, ...: every f32 call of flash and ssd, and
    every shape the main routes refuse); rmsnorm has one route."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    return {"rmsnorm": rmsnorm_ops.launches, "flash_attention": flash_ops.launches,
            "decode_attention": decode_ops.launches, "ssd": ssd_ops.launches,
            "flash_attention_bwd": flash_ops.bwd_launches, "rmsnorm_bwd": rmsnorm_ops.bwd_launches,
            "ssd_bwd": ssd_ops.bwd_launches, "flash_attention_wide": flash_ops.wide_launches,
            "flash_attention_bwd_wide": flash_ops.wide_bwd_launches, "decode_attention_wide": decode_ops.wide_launches,
            "ssd_wide": ssd_ops.wide_launches, "ssd_bwd_wide": ssd_ops.wide_bwd_launches}


def _on_routes(cfg, counts: dict) -> dict:
    """``counts`` (launches by kernel name) moved onto the routes that
    ``cfg``'s shapes take, as each wrapper's ``route`` picks them: a
    float32 model's attention and ssd (both ways), and a head dim above 256
    (decode too), count under the wide routes' names.  Every name of
    ``_kernel_ops`` is present."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    dtype = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    dk, dv = ((cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim, cfg.mla.v_head_dim) if cfg.mla is not None
              else (cfg.head_dim, cfg.head_dim))
    flash = flash_ops.route(dk, dv, dtype) == "wide"
    ssd = cfg.ssm is not None and ssd_ops.route(cfg.ssm.chunk_size, cfg.ssm.head_dim, cfg.ssm.d_state,
                                                 dtype) == "wide"
    wide = {"flash_attention": flash, "flash_attention_bwd": flash, "ssd": ssd, "ssd_bwd": ssd,
            "decode_attention": decode_ops.route(cfg.head_dim, cfg.head_dim) == "wide"}
    out = dict.fromkeys(_kernel_ops(), 0)
    for name, n in counts.items():
        out[name + "_wide" if wide.get(name) else name] += n
    return out


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

    reqs = [eng.submit(p, 3 * n_iter + 2) for p in prompts]
    eng.step()  # admissions (prefills) outside the windows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_iter
    with device_trace() as prof:
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


def _profile_call(fn, n_iter: int = 3, n_prof: int = 1) -> dict:
    """``fn()`` (a prefill, an encode, a decode step) with nothing else
    running: wall time (host clock around a synchronised call, median of
    ``n_iter``), then device time by kernel and the busy share of
    ``n_prof`` profiled calls."""

    walls = []
    for _ in range(n_iter):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with device_trace() as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_prof):
            fn()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    return dict(wall_ms=sorted(walls)[n_iter // 2], **_device_rows(prof, prof_wall_ms, n_prof))


def _log_profile(what: str, p: dict) -> None:
    """The ``[profile]`` lines of a :func:`_profile_call` result."""
    log(f"[profile] {what}: {p['wall_ms']:.2f} ms wall (median of 3); under the profiler "
        f"{p['profiled_wall_ms']:.2f} ms wall, {p['device_ms']:.2f} ms device time, device busy {p['busy']:.1%}")
    for name, ms in p["top"]:
        log(f"[profile]   {ms:8.4f} ms  {name}")
    log("[profile] by kind: " + ", ".join(f"{k} {ms:.2f} ms ({ms / p['device_ms']:.1%})" for k, ms in p["kinds"]))


def serving_phase(dev, arch: str = "deepseek-7b", tag: str = "serve", n_layers: int | None = None) -> dict:
    """Full-width ``arch`` (seeded random bf16 weights made on the card;
    ``n_layers`` cuts the depth) through ``ServeEngine``: 4 slots,
    ``MAX_SEQ``; the ragged prompts and a sampled one, then duplicates
    (prefix share, restore); exact launch counts; one greedy stream
    against the sequential loop; a profiled decode iteration and 2048-token
    prefill; peak memory.  Dense (deepseek-7b, gemma-7b), MLA
    (minicpm3-4b: the latent rows are paged) and MoE (qwen3-moe)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
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
        by_shape = {name: dict(c.by_shape) for name, c in ops.items()}
        # --------------------------------------------------------------------
        stats = eng.stats()
        stats.update(prefills=eng.prefills - base[0], decode_steps=eng.decode_steps - base[1],
                     restores=eng.restores - base[2])
        peak = torch.cuda.max_memory_allocated()
        step_profile = _profile_decode(eng, warm)
    prefill_profile = _profile_call(functools.partial(
        prefill, model, {"tokens": torch.from_numpy(prompts[0][None, :]).to(dev)}, cfg))

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
    _log_profile(f"{arch} prefill of {PROMPT_LENS[0]} tokens alone", pp)
    return dict(
        launches=launches, launches_by_shape=by_shape, tok_per_s=n_tok / wall, wall_s=wall, peak_bytes=peak,
        stats=stats,
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
    from repro_torch.models import init_params, prefill
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
    prefill_profile = _profile_call(functools.partial(
        prefill, model, {"tokens": torch.from_numpy(prompts[0][None, :]).to(dev)}, cfg))

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
    _log_profile(f"{arch} prefill of {M_PROMPT_LENS[0]} tokens alone", pp)
    mixer = "ssd_chunk" if cfg.ssm else "flash_fwd"
    mixer_ms = sum(ms for name, ms in pp["top"] if mixer in name)
    share = f"{mixer_ms / pp['device_ms']:.1%}" if pp["device_ms"] else "the trace holds no kernel"
    log(f"[profile] the {mixer} kernel takes {mixer_ms:.3f} ms of that prefill's {pp['device_ms']:.2f} ms of "
        f"device time ({share})")
    return dict(
        launches=launches, tok_per_s=n_tok / wall, wall_s=wall, peak_bytes=peak, stats=stats,
        ttft_ms=[(r.t_first - r.t_arrival) * 1e3 for r in reqs], decode_profile=sp,
        prefill_profile=pp,
    )


# ---------------------------------------------------------------------------
# 7. whole model: card against CPU
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# 6b. the frontends: hubert-xlarge (audio encoder) and internvl2-2b (vision)
# ---------------------------------------------------------------------------

HUBERT_B, HUBERT_L = 2, 4096  # frames a serving call; every 4th masked
IVL_TEXT = 1792  # text tokens after internvl's 256 patches: 2048 a sequence
IVL_GEN = 16  # greedy decode steps


def _audio_batch(cfg, B: int, L: int, dev, seed: int) -> dict:
    """Seeded frame embeddings (B, L, 512) float32 and a mask of every 4th
    frame (``repro``'s smoke test)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.zeros((B, L), dtype=torch.bool, device=dev)
    mask[:, ::4] = True
    return {"embeds": torch.randn((B, L, 512), generator=gen, device=dev), "mask": mask}


def _rel_err(got, want, n_classes: int) -> float:
    """max |got - want| / max |want| over the first ``n_classes`` logits (a
    vision model's padded classes hold -1e30)."""
    got, want = got[..., :n_classes].float().cpu(), want[..., :n_classes].float().cpu()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max())


def _encode(model, batch, cfg):
    """hubert's serving call: the encoder forward and the head over every
    frame (``forward`` + ``head_logits``, the entry points)."""
    from repro_torch.models import forward, head_logits

    with torch.no_grad():
        x, _, _ = forward(model, batch, cfg)
        return head_logits(model, x, cfg)


def encoder_serving_phase(dev, arch: str = "hubert-xlarge", tag: str = "serve-hubert") -> dict:
    """Full-width hubert-xlarge (48 layers, 16 heads of 80, bf16, seeded
    random init): the encoder forward and the head over (2, 4096) seeded
    frame embeddings, every 4th frame masked: exact launch counts (one
    non-causal flash call a layer, two norms a layer and the final one),
    finite logits of (2, 4096, 512), run to run identical; wall and device
    ms, busy share, peak memory.  Then 2 layers in float32: the card's
    logits against the CPU port's (plain versions) within 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer, init_params

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    assert cfg.frontend == "audio" and cfg.is_encoder
    t0 = time.perf_counter()
    model = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[{tag}] {arch} ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, "
        f"{cfg.vocab} classes padded to {cfg.padded_vocab}, {n_params / 1e9:.3f} B params, {cfg.dtype}) initialised "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    batch = _audio_batch(cfg, HUBERT_B, HUBERT_L, dev, 0)
    _encode(model, batch, cfg)  # warm-up: first-use costs of each shape
    ops = _kernel_ops()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts from 0 just before, read just after ----
    for c in ops.values():
        c.reset()
    logits = _encode(model, batch, cfg)
    torch.cuda.synchronize()
    launches = {name: c.count for name, c in ops.items()}
    by_shape = {name: dict(c.by_shape) for name, c in ops.items()}
    # --------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    want = _serve_launches(cfg, prefills=1, decode_steps=0)
    log(f"[{tag}] launches on the main path {launches}; expected {want} (one encoder forward)")
    assert launches == want, "the encoder did not run through every kernel as expected"
    assert logits.shape == (HUBERT_B, HUBERT_L, cfg.padded_vocab) and bool(torch.isfinite(logits).all())
    same = torch.equal(_encode(model, batch, cfg), logits)
    log(f"[{tag}] logits {tuple(logits.shape)} finite; run to run identical: {same}")
    assert same
    frames = HUBERT_B * HUBERT_L
    prof = _profile_call(lambda: _encode(model, batch, cfg))
    wall = prof["wall_ms"]
    log(f"[{tag}] {HUBERT_B} x {HUBERT_L} frames in {wall:.2f} ms ({frames / wall * 1e3:.1f} frames/s), peak "
        f"device memory {peak / 2**30:.2f} GiB ({peak} bytes)")
    _log_profile(f"{arch} encoder forward + head of {HUBERT_B} x {HUBERT_L} frames", prof)
    del model, logits
    gc.collect()
    torch.cuda.empty_cache()
    # fp32 at 2 layers: the card (kernels) against the CPU port (plain versions)
    torch.backends.cuda.matmul.allow_tf32 = False
    small = cfg.replace(n_layers=2, dtype="float32")
    gpu = init_params(small, 1, device=dev)
    cpu = Transformer(small, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    b = _audio_batch(small, 2, 512, dev, 1)
    err = _rel_err(_encode(gpu, b, small), _encode(cpu, {k: v.cpu() for k, v in b.items()}, small), small.padded_vocab)
    log(f"[{tag}] {small.n_layers}-layer full-width fp32, 2 x 512 frames, card vs CPU: max relative logit error "
        f"{err:.3e} (limit 1e-3)")
    assert err <= 1e-3
    del gpu, cpu
    return dict(launches=launches, launches_by_shape=by_shape, wall_ms=wall, frames_per_s=frames / wall * 1e3,
                peak_bytes=peak, profile=prof, fp32_err=err)


def _vision_inputs(cfg, B: int, n_text: int, dev, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded patch embeddings (B, n_patches, 1024) float32 and text tokens
    (B, n_text) int32 in [0, vocab)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    patches = torch.randn((B, cfg.n_patches, 1024), generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (B, n_text), generator=gen, device=dev, dtype=torch.int32)
    assert int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab  # as drawn (ROADMAP F3)
    return patches, tokens


def _vision_greedy(model, cfg, patches, tokens, max_seq: int, n_steps: int, times: list | None = None):
    """Prefill of the patches and text, ``prime_cache`` at ``max_seq`` rows,
    then ``n_steps`` greedy ``decode_step``s at positions ``n_patches +
    text + s``.  → the stream (B, 1 + n_steps); each step's host-clock ms
    appended to ``times``."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.runtime.serve import prime_cache

    start = cfg.n_patches + tokens.shape[1]
    logits, caches = prefill(model, {"tokens": tokens, "patch_embeds": patches}, cfg)
    caches = prime_cache(cfg, caches, start, max_seq)
    out = [torch.argmax(logits[:, -1], dim=-1).to(torch.int32)]
    for s in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = decode_step(model, out[-1][:, None], caches, start + s, cfg)
        out.append(torch.argmax(logits[:, -1], dim=-1).to(torch.int32))
        torch.cuda.synchronize()
        if times is not None:
            times.append((time.perf_counter() - t0) * 1e3)
    return torch.stack(out, dim=1)


def _vision_check(dev, cfg, steps: int = 4, text: int = 256) -> float:
    """internvl at 2 layers, float32: prefill of 256 patches + ``text``
    tokens and ``steps`` - 1 teacher-forced decode steps at positions
    ``n_patches + text + s`` on the card, each within 1e-3 of the card's
    full forward at that position and of the CPU port's prefill / decode.
    → the worst relative error."""
    from repro_torch.models import Transformer, decode_step, forward, head_logits, init_params, prefill
    from repro_torch.runtime.serve import prime_cache

    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = init_params(cfg, 1, device=dev)
    cpu = Transformer(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    patches, tokens = _vision_inputs(cfg, 2, text + steps, dev, 2)
    off, V = cfg.n_patches, cfg.vocab
    with torch.no_grad():
        x, _, _ = forward(gpu, {"tokens": tokens, "patch_embeds": patches}, cfg)
        full = head_logits(gpu, x, cfg)
    pb = {"tokens": tokens[:, :text], "patch_embeds": patches}
    lg, cg = prefill(gpu, pb, cfg)
    lc, cc = prefill(cpu, {k: v.cpu() for k, v in pb.items()}, cfg)
    worst = max(_rel_err(lg[:, 0], full[:, off + text - 1], V), _rel_err(lg, lc, V))
    size = off + text + 8
    cg, cc = prime_cache(cfg, cg, off + text, size), prime_cache(cfg, cc, off + text, size)
    for s in range(steps - 1):
        pos, tok = off + text + s, tokens[:, text + s:text + s + 1]
        lg, cg = decode_step(gpu, tok, cg, pos, cfg)
        lc, cc = decode_step(cpu, tok.cpu(), cc, pos, cfg)
        worst = max(worst, _rel_err(lg[:, 0], full[:, pos], V), _rel_err(lg, lc, V))
    del gpu, cpu
    return worst


def vision_serving_phase(dev, arch: str = "internvl2-2b", tag: str = "serve-internvl") -> dict:
    """Full-width internvl2-2b (24 layers, 16 / 8 heads of 128, bf16,
    seeded random init): 4 sequences of 256 seeded patch embeddings and
    1792 text tokens prefilled together, ``prime_cache`` at ``MAX_SEQ``
    rows, then ``IVL_GEN`` greedy ``decode_step``s from position 2048:
    exact launch counts, the stream identical on a second run; prefill and
    decode-iteration wall and device ms, peak memory.  Then 2 layers in
    float32 (``_vision_check``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    assert cfg.frontend == "vision" and cfg.n_patches + IVL_TEXT + IVL_GEN <= MAX_SEQ
    t0 = time.perf_counter()
    model = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[{tag}] {arch} ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim} on "
        f"{cfg.n_kv_heads} KV heads, vocab {cfg.vocab}, {cfg.n_patches} patches, {n_params / 1e9:.3f} B params, "
        f"{cfg.dtype}) initialised on the card in {time.perf_counter() - t0:.1f} s")
    patches, tokens = _vision_inputs(cfg, N_SLOTS, IVL_TEXT, dev, 0)
    _vision_greedy(model, cfg, patches, tokens, MAX_SEQ, 2)  # warm-up
    ops = _kernel_ops()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts from 0 just before, read just after ----
    for c in ops.values():
        c.reset()
    step_ms: list = []
    stream = _vision_greedy(model, cfg, patches, tokens, MAX_SEQ, IVL_GEN, step_ms)
    launches = {name: c.count for name, c in ops.items()}
    by_shape = {name: dict(c.by_shape) for name, c in ops.items()}
    # --------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    want = _serve_launches(cfg, prefills=1, decode_steps=IVL_GEN)
    log(f"[{tag}] launches on the main path {launches}; expected {want} (one prefill of {N_SLOTS} sequences, "
        f"{IVL_GEN} decode steps)")
    assert launches == want, "the vision path did not run through every kernel as expected"
    assert int(stream.min()) >= 0 and int(stream.max()) < cfg.vocab, "a token in the padded classes"
    again = _vision_greedy(model, cfg, patches, tokens, MAX_SEQ, IVL_GEN)
    log(f"[{tag}] streams (first 8 of each) {stream[:, :8].tolist()}; identical on a second run: "
        f"{torch.equal(again, stream)}")
    assert torch.equal(again, stream)
    batch = {"tokens": tokens, "patch_embeds": patches}
    pre_prof = _profile_call(lambda: prefill(model, batch, cfg))
    pre_wall = pre_prof["wall_ms"]
    _log_profile(f"{arch} prefill of {N_SLOTS} x ({cfg.n_patches} patches + {IVL_TEXT} tokens)", pre_prof)
    from repro_torch.models import decode_step
    from repro_torch.runtime.serve import prime_cache

    _, caches = prefill(model, batch, cfg)
    caches = prime_cache(cfg, caches, cfg.n_patches + IVL_TEXT, MAX_SEQ)
    tok = stream[:, :1].contiguous()
    pos = cfg.n_patches + IVL_TEXT
    dec_prof = _profile_call(lambda: decode_step(model, tok, caches, pos, cfg), n_prof=4)
    dec_wall = float(np.median(step_ms))
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    _log_profile(f"{arch} decode iteration of {N_SLOTS} sequences at position {pos}", dec_prof)
    log(f"[{tag}] decode step wall ms {[round(t, 2) for t in step_ms]}: median {dec_wall:.2f} ms "
        f"({N_SLOTS / dec_wall * 1e3:.1f} tok/s); reading the {weight_bytes / 1e9:.2f} GB of weights once takes "
        f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms; peak device memory {peak / 2**30:.2f} GiB ({peak} bytes)")
    del model, caches
    gc.collect()
    torch.cuda.empty_cache()
    small = cfg.replace(n_layers=2, dtype="float32")
    err = _vision_check(dev, small)
    log(f"[{tag}] {small.n_layers}-layer full-width fp32, {small.n_patches} patches + 256 tokens, prefill and 3 "
        f"decode steps: max relative logit error {err:.3e} against the card's full forward and the CPU port "
        "(limit 1e-3)")
    assert err <= 1e-3
    return dict(launches=launches, launches_by_shape=by_shape, prefill_ms=pre_wall, prefill_profile=pre_prof,
                decode_ms=dec_wall, decode_profile=dec_prof, tok_per_s=N_SLOTS / dec_wall * 1e3, peak_bytes=peak,
                fp32_err=err)


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
    functions' forwards included; ``"dots_saveable"`` too: it keeps only
    the matrix products' outputs), and one backward of each."""
    remat = 2 if cfg.remat in ("full", "dots_saveable") else 1
    c = _layer_launches(cfg)
    return _on_routes(cfg, {
        "flash_attention": n_mb * remat * c["flash"],
        "flash_attention_bwd": n_mb * c["flash"],
        "ssd": n_mb * remat * c["ssd"],
        "ssd_bwd": n_mb * c["ssd"],
        "rmsnorm": n_mb * (remat * (c["norms"] - 1) + 1),
        "rmsnorm_bwd": n_mb * c["norms"],
    })


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
    on_card = {n: t.to(dev) for n, t in grads_c.items()}  # the CPU's gradients, copied once
    worst, at = -1.0, None
    for n, t in grads_g.items():
        w = on_card[n]
        share = float((t - w).abs().max() / (1e-4 * w.abs().max() + 1e-12))
        if share > worst:
            worst, at = share, n
    mg = dict(loss=loss_g, grad_norm=float(global_norm(grads_g.values())))
    mc = dict(loss=loss_c, grad_norm=float(global_norm(grads_c.values())))
    del grads_g, w
    cpu = _apply_update(cpu, grads_c, update, lr)
    gpu = _apply_update(gpu, on_card, update, lr)
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
    counts per step (float32: flash and ssd on the wide routes).

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


@contextlib.contextmanager
def _host_memory_kept():
    """While the block runs, glibc keeps the host memory that is freed (no
    blocks of their own mapped for large allocations, no trimming), and
    hands it back at the end.  The CPU side of a parity run allocates and
    frees tensors of gigabytes at every op; on a fresh mapping each page
    faults in first, which on the H100 machine's host made a 4 GiB
    elementwise op ~5x slower and gemma-7b's two-step parity 97.3 s
    against 50.1.  Afterwards the thresholds are where glibc's dynamic
    rule tops out (mmap above 32 MiB, trim above twice that)."""
    libc = ctypes.CDLL("libc.so.6")
    m_trim_threshold, m_mmap_threshold, m_mmap_max = -1, -3, -4
    libc.mallopt(m_mmap_max, 0)
    libc.mallopt(m_trim_threshold, -1)
    try:
        yield libc
    finally:
        libc.mallopt(m_mmap_max, 65536)
        libc.mallopt(m_mmap_threshold, 32 << 20)
        libc.mallopt(m_trim_threshold, 64 << 20)
        libc.malloc_trim(0)


def train_parity_phase(dev) -> dict:
    """Full width, depth cut, float32, B = 2, two microbatches, one or two
    steps (``_parity_run``; cut for the script's time limit): deepseek-7b
    (1 layer, L = 128, one step) with Adafactor and with AdamW,
    gemma-7b (1 layer, L = 128, one step; head dim 256: the wide routes
    of the flash forward and backward at Dh 256), minicpm3-4b (1 MLA
    layer, L = 256, two steps), recurrentgemma-9b (3 layers, L = 128,
    one step) and qwen3-moe-235b-a22b (1 layer, L = 128, one step) with
    Adafactor; hubert-xlarge (1 layer, 256 frames, non-causal) and
    internvl2-2b (1 layer, 256 patches + 128 text tokens) with their
    config's AdamW, two steps each."""
    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    # the CPU side is most of this phase's time (gemma-7b's 256000-row tied
    # head takes ~100 s at 256 tokens a sequence, recurrentgemma-9b's and
    # qwen3-moe's are as slow): those three run at 128, one step each.
    # Depths: one layer, but recurrentgemma-9b's one (rec, rec, attn)
    # super-block.  Host memory is kept between ops
    # within a run and handed back after it (qwen3-moe's CPU side holds
    # ~68 GB of the host's 96 GiB then)
    with _host_memory_kept() as libc:
        for arch, opt, seq, n_layers, steps in (
                ("deepseek-7b", "adafactor", 128, 1, 1), ("deepseek-7b", "adamw", 128, 1, 1),
                ("gemma-7b", "adafactor", 128, 1, 1), ("minicpm3-4b", "adafactor", 256, 1, 2),
                ("recurrentgemma-9b", "adafactor", 128, 3, 1), ("qwen3-moe-235b-a22b", "adafactor", 128, 1, 1),
                ("hubert-xlarge", "adamw", 256, 1, 2), ("internvl2-2b", "adamw", 384, 1, 2)):
            cfg = get_config(arch)
            # one logits chunk: a vision model's over its text positions; audio reads none
            chunk = None if cfg.frontend == "audio" else seq - (cfg.n_patches if cfg.frontend == "vision" else 0)
            cfg = cfg.replace(n_layers=n_layers, dtype="float32", logits_chunk=chunk, optimizer=opt)
            out[opt if arch == "deepseek-7b" else arch] = _parity_run(dev, cfg, tag="train-parity", seq=seq,
                                                                      steps=steps)
            rss = next((line.split(":")[1].strip() for line in open("/proc/self/status")
                        if line.startswith("VmRSS")), "unknown")
            log(f"[train-parity] host memory held after {arch} {opt}: {rss}")
            libc.malloc_trim(0)
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
    with device_trace() as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = art(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return state, m, _device_rows(prof, wall_ms, 1)


def _model_flops(cfg, params: dict, seq: int) -> tuple[float, float]:
    """Model FLOPs of one train step of (TRAIN_BATCH, seq) — 6 a parameter
    and position it multiplies, no recompute — plus attention's 3 ×
    2·H·(Dk + Dv) an unmasked pair (every pair for an encoder), and the
    parameters in matrix products.  Not the embedding gather, the norm
    scales, biases, gates' diagonals nor the rec layers' conv taps, but a
    tied embedding is also the logits product's matrix; a MoE layer's
    experts count at top_k / n_experts (the active parameters).  A vision
    model's patch projection multiplies its patches, its logits product
    the text positions; an audio model's frame projection and head every
    frame."""
    positions = TRAIN_BATCH * seq
    patches = TRAIN_BATCH * cfg.n_patches if cfg.frontend == "vision" else 0
    per_param = {"patch_proj": patches, "unembed": positions - patches}
    flops = n_matmul = 0.0
    for n, p in params.items():
        if p.dim() < 2 or n.endswith("conv_w") or (n == "embedding" and not cfg.tie_embeddings):
            continue
        k = p.numel() * (cfg.moe.top_k / cfg.moe.n_experts if cfg.moe and ".moe.w" in n else 1.0)
        n_matmul += k
        flops += 6 * k * per_param.get("unembed" if n == "embedding" else n, positions)
    if cfg.tie_embeddings:  # the gather of a tied table is not a product; its logits are
        n_matmul -= params["embedding"].numel() - cfg.vocab * cfg.d_model
        flops -= 6 * (params["embedding"].numel() - cfg.vocab * cfg.d_model) * positions
    dk, dv = ((cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim, cfg.mla.v_head_dim) if cfg.mla
              else (cfg.head_dim, cfg.head_dim))
    window = cfg.hybrid.window if cfg.hybrid else cfg.attn_window
    attn = (3 * 2 * cfg.n_heads * (dk + dv) * _pairs(seq, seq, not cfg.is_encoder, window, 0) * TRAIN_BATCH
            * _layer_launches(cfg)["flash"])
    return flops + attn, n_matmul


# the train runs: arch → (its layers here, the phase's tag, nonfinite rollback);
# deepseek-7b at full depth, qwen3-moe at the fixed cut above
TRAIN_RUNS = {"deepseek-7b": (30, "train", True),
              # the others at a quarter of their depth or less (minicpm3-4b and
              # recurrentgemma-9b an eighth, two super-blocks): the script's time limit
              "gemma-7b": (7, "train-gemma", False),
              "minicpm3-4b": (8, "train-minicpm3", False),
              "recurrentgemma-9b": (6, "train-rgemma", False),
              "qwen3-moe-235b-a22b": (MOE_TRAIN_LAYERS, "train-moe", False),
              "hubert-xlarge": (12, "train-hubert", False), "internvl2-2b": (6, "train-internvl", False),
              "qwen1.5-110b": (NEW_TRAIN_LAYERS, "train-qwen110b", False),
              "llama4-scout-17b-a16e": (NEW_TRAIN_LAYERS, "train-llama4", False)}
# timed steps a run: the other families' runs time 2 (the first is warm-up),
# to keep the script inside its time limit
TRAIN_STEPS_OF = {"minicpm3-4b": 3, "recurrentgemma-9b": 3, "qwen3-moe-235b-a22b": 3, "hubert-xlarge": 3,
                  "internvl2-2b": 3, "qwen1.5-110b": 3, "llama4-scout-17b-a16e": 3}
# the frontends train at their own sequence (4096 positions: internvl's 256
# patches + 3840 text tokens, 5 logits chunks of 768) with their config's
# optimizer (AdamW); the others at TRAIN_SEQ with Adafactor
FRONTEND_TRAIN_SEQ = 4096


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
    from repro_torch.runtime.train import build_train_step, init_train_state, state_bytes

    n_layers, tag, rollback = TRAIN_RUNS[arch]
    n_steps = TRAIN_STEPS_OF.get(arch, TRAIN_STEPS)
    gc.collect()  # the serving phases' models and engines are cyclic garbage
    torch.cuda.empty_cache()
    mem_base = torch.cuda.memory_allocated()
    full = get_config(arch)
    if full.frontend:
        seq, cfg = FRONTEND_TRAIN_SEQ, full.replace(n_layers=n_layers)
        assert (cfg.remat, cfg.dtype, cfg.optimizer) == ("full", "bfloat16", "adamw")
        assert cfg.logits_chunk == (768 if cfg.frontend == "vision" else None)
    else:
        seq, cfg = TRAIN_SEQ, full.replace(optimizer="adafactor", n_layers=n_layers)
        assert (cfg.remat, cfg.logits_chunk, cfg.dtype) == ("full", 1024, "bfloat16")
    t0 = time.perf_counter()
    state = init_train_state(cfg, 0, device=dev)
    torch.cuda.synchronize()
    params = dict(state.params.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    tokens = TRAIN_BATCH * seq
    model_flops, n_matmul = _model_flops(cfg, params, seq)
    cut = f" of {full.n_layers}" if n_layers != full.n_layers else ""
    log(f"[{tag}] {arch} ({cfg.n_layers}{cut} layers, {n_params / 1e9:.3f} B params, {n_matmul / 1e9:.3f} B "
        f"{'active ' if cfg.moe else ''}in matrix products, {cfg.dtype}, {cfg.optimizer}, remat {cfg.remat}, "
        f"logits chunk {cfg.logits_chunk}) initialised on the card in {time.perf_counter() - t0:.1f} s "
        f"({mem_base} bytes allocated before it)")
    art = build_train_step(cfg, n_microbatches=TRAIN_MB, schedule_policy="overlap")
    batches = _batches(cfg, dev, n_steps + 2, TRAIN_BATCH, seq)  # + timed / profiled and rollback steps
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
    by_shape = {name: dict(c.by_shape) for name, c in ops.items()}
    # ------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    # what the dry run's argument bytes count: the state, the step, one batch
    sb = state_bytes(state)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    arg_bytes = sb["params"] + sb["opt"] + nbytes([state.step]) + nbytes(batches[0].values())
    # allocated besides one step's arguments and temporaries: what was there
    # before the init, and the other batches
    extra_bytes = mem_base + sum(nbytes(b.values()) for b in batches[1:])
    want = {k: v * n_steps for k, v in _train_launches_per_step(cfg, TRAIN_MB).items()}
    log(f"[{tag}] launches on the main path {launches}; expected {want} from {n_steps} steps of "
        f"{TRAIN_MB} microbatches")
    assert launches == want, "the train step did not run through every kernel as expected"
    assert all(np.isfinite(losses)) and all(np.isfinite(gnorms)), (losses, gnorms)
    assert int(state.step) == n_steps
    assert art.schedule_names == ["mb0", "mb1", "grad_allreduce", "optimizer"], art.schedule_names
    step_ms = float(np.median(walls[1:]))
    tflops = model_flops / (step_ms / 1e3) / 1e12
    log(f"[{tag}] losses {losses}, grad norms {gnorms}; schedule {art.schedule_names}")
    if cfg.moe:
        log(f"[{tag}] aux metrics of the last step: moe_balance {float(m['moe_balance']):.4f}, moe_zloss "
            f"{float(m['moe_zloss']):.4f}")
    log(f"[{tag}] step wall ms {[round(w, 2) for w in walls]}; median of steps 2-{n_steps} {step_ms:.2f} ms, "
        f"{tokens / step_ms * 1e3:.1f} {'frames' if cfg.frontend == 'audio' else 'tokens'}/s, model "
        f"{model_flops / 1e12:.1f} TFLOP a step "
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
    out = dict(launches=launches, launches_by_shape=by_shape, losses=losses, grad_norms=gnorms, walls_ms=walls,
               step_ms=step_ms, tokens_per_s=tokens / step_ms * 1e3, model_tflops=tflops, peak_bytes=peak,
               profile=prof, task_ms=spans, cfg=cfg, arg_bytes=arg_bytes, extra_bytes=extra_bytes)
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

REMAT_STEPS = 3  # staged steps a mode (the first is warm-up)


def _mb_grads(model, cfg, mb: dict) -> tuple:
    """One microbatch's loss and every parameter's gradient, as the train
    step's microbatch codelet forms them (``loss_fn``, ``torch.autograd.grad``)."""
    from repro_torch.models import loss_fn

    with torch.enable_grad():
        loss, _ = loss_fn(model, mb, cfg)
        grads = torch.autograd.grad(loss, [p for p in model.parameters()])
    return loss.detach(), grads


# of deepseek-7b's 30 layers: half, for the script's time limit ([train] reads
# the full-depth peak of remat="full" on the same config)
REMAT_LAYERS = 8


def remat_phase(dev, arch: str = "deepseek-7b", tag: str = "remat") -> dict:
    """deepseek-7b at full width cut to ``REMAT_LAYERS`` (bf16, Adafactor),
    (2, 2048) in 2 microbatches, under ``remat="dots_saveable"`` against
    ``"full"``: each microbatch's loss and every parameter's gradient bit
    for bit from the same weights (the step's float32 accumulator adds
    these in the same order, so its gradients are too); then
    ``REMAT_STEPS`` staged steps a mode from one state, full /
    dots_saveable / full (median of the steps after the first, peak device
    memory; one profiled step's device time and busy share of the first
    two), exact launch counts of every mode's steps."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.train import build_train_step, init_train_state

    gc.collect()
    torch.cuda.empty_cache()
    base = get_config(arch).replace(optimizer="adafactor", n_layers=REMAT_LAYERS)
    assert (base.remat, base.logits_chunk, base.dtype) == ("full", 1024, "bfloat16")
    modes = {r: base.replace(remat=r) for r in ("full", "dots_saveable")}
    state = init_train_state(base, 0, device=dev)
    batches = _batches(base, dev, REMAT_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    names = [n for n, _ in state.params.named_parameters()]
    rows = TRAIN_BATCH // TRAIN_MB
    differing, worst, losses = [], 0.0, []
    for i in range(TRAIN_MB):
        mb = {k: v[i * rows:(i + 1) * rows] for k, v in batches[0].items()}
        lf, gf = _mb_grads(state.params, modes["full"], mb)
        ld, gd = _mb_grads(state.params, modes["dots_saveable"], mb)
        losses.append((float(lf), float(ld), torch.equal(_bits(lf), _bits(ld))))
        for n, a, b in zip(names, gf, gd):
            if not torch.equal(_bits(a), _bits(b)):
                differing.append(f"mb{i}:{n}")
                worst = max(worst, float((a.float() - b.float()).abs().max()))
        del gf, gd
    log(f"[{tag}] {arch} ({base.n_layers} layers, bf16): microbatch losses full / dots_saveable {losses}; "
        f"gradients of {len(names)} parameters x {TRAIN_MB} microbatches bit for bit equal: "
        f"{not differing} (differing {differing[:8]}, worst |difference| {worst:.3e})")
    assert all(same for _, _, same in losses) and not differing, (losses, differing[:8], worst)
    ops = _kernel_ops()
    runs = []
    for remat in ("full", "dots_saveable", "full"):
        profiled = len(runs) < 2  # a profiled deepseek step costs ~15 s of the script's time
        gc.collect()
        torch.cuda.empty_cache()
        art = build_train_step(modes[remat], n_microbatches=TRAIN_MB, schedule_policy="overlap")
        torch.cuda.reset_peak_memory_stats()
        for c in ops.values():
            c.reset()
        walls = []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = art(state, b)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
        launches = {name: c.count for name, c in ops.items()}
        want = {k: v * REMAT_STEPS for k, v in _train_launches_per_step(modes[remat], TRAIN_MB).items()}
        assert launches == want, (remat, launches, want)
        peak = torch.cuda.max_memory_allocated()
        runs.append(dict(remat=remat, walls_ms=walls, step_ms=float(np.median(walls[1:])), peak_bytes=peak,
                         launches=launches))
        log(f"[{tag}] remat {remat}: step wall ms {[round(w, 2) for w in walls]}, median of steps "
            f"2-{REMAT_STEPS} {runs[-1]['step_ms']:.2f} ms, peak device memory {peak / 2**30:.2f} GiB ({peak} "
            f"bytes); launches {launches} (as expected)")
        if profiled:
            state, _, prof = _profile_train_step(art, state, batches[0])
            runs[-1]["profile"] = prof
            log(f"[{tag}] remat {remat}: a profiled step {prof['profiled_wall_ms']:.2f} ms wall, "
                f"{prof['device_ms']:.2f} ms device, busy {prof['busy']:.1%}; by kind "
                + ", ".join(f"{k} {ms:.1f} ms" for k, ms in prof["kinds"]))
        del art
    full = [r for r in runs if r["remat"] == "full"]
    dots = runs[1]
    full_ms = float(np.mean([r["step_ms"] for r in full]))
    full_dev = full[0]["profile"]["device_ms"]
    log(f"[{tag}] dots_saveable against full (the two full runs' mean): step {dots['step_ms']:.2f} against "
        f"{full_ms:.2f} ms ({dots['step_ms'] - full_ms:+.2f} ms), device time of a profiled step (the first full "
        f"run's) "
        f"{dots['profile']['device_ms']:.2f} against {full_dev:.2f} ms "
        f"({dots['profile']['device_ms'] - full_dev:+.2f} ms), peak {dots['peak_bytes'] / 2**30:.2f} against "
        f"{full[0]['peak_bytes'] / 2**30:.2f} GiB ({(dots['peak_bytes'] - full[0]['peak_bytes']) / 2**30:+.2f} GiB)")
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=dots["launches"], runs=runs, full_ms=full_ms, dots_ms=dots["step_ms"],
                full_peak=full[0]["peak_bytes"], dots_peak=dots["peak_bytes"], losses=losses)


SPEC_K = 4
# the speculation and load phases' deepseek-7b, cut in depth to keep the
# script inside its time limit (the serving and train phases run all 30)
SPEC_LAYERS = 6
LOAD_SPEC = dict(seed=0, n_requests=8, rate_rps=2.0, prompt_lens=(128, 512, 1024, 2048),
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
    return _on_routes(cfg, {
        "flash_attention": c["flash"] * prefills + d["flash"] * primes,
        "decode_attention": c["decode"] * (decode_steps + verify_substeps) + d["decode"] * draft_feeds,
        "rmsnorm": c["norms"] * fwd + d["norms"] * (primes + draft_feeds),
        "ssd": c["ssd"] * prefills,
    })


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

    reqs = [eng.submit(p, GEN) for p in prompts]
    eng.step()  # admissions
    rounds = eng._spec.rounds
    with device_trace() as prof:
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


COMM_LAYERS = 6  # of mamba2-130m's 24: the payload's depth (the script's time limit)


def _comm_n() -> int:
    """The payload: the parameter count of mamba2-130m cut to
    ``COMM_LAYERS`` layers, the gradient a data-parallel rank of that model
    reduces."""
    from repro_torch.configs import get_config

    return get_config("mamba2-130m").replace(n_layers=COMM_LAYERS).param_count()


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
    """14. Communication in the task graph at the gradient size of
    mamba2-130m cut to ``COMM_LAYERS`` layers: (a) in-process, (b) across
    processes, (c) rank death, (d) the launcher."""
    gc.collect()
    torch.cuda.empty_cache()
    n = _comm_n()
    t0 = time.perf_counter()
    log(f"[comm] payload: the {n} parameters of mamba2-130m at {COMM_LAYERS} layers as float32, {n * 4} bytes "
        f"a rank")
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


# ---------------------------------------------------------------------------
# 15. pipeline parallelism: F / L / B tasks on worker threads of the card
# ---------------------------------------------------------------------------

PIPE_STAGES = 4
PIPE_MB = 4  # microbatches of (1, PIPE_SEQ)
PIPE_SEQ = 2048
PIPE_LAYERS = 8  # of deepseek-7b's 30: 2 a stage (16 fit beside 4 microbatches' activations, remat off)
PIPE_FP32_LAYERS = 4  # the fp32 parity's cut: one layer a stage
PIPE_TOL = {"bfloat16": 2e-2, "float32": 1e-5}  # of each leaf's largest |gradient|


def _pipeline_launches(cfg) -> dict:
    """One pipelined forward + backward of ``PIPE_MB`` microbatches (remat
    off): per microbatch and layer a flash forward and backward and two
    norms each way, plus the head's final norm each way."""
    n = cfg.n_layers
    per = dict(flash_attention=n, flash_attention_bwd=n, rmsnorm=2 * n + 1, rmsnorm_bwd=2 * n + 1)
    return _on_routes(cfg, {k: PIPE_MB * v for k, v in per.items()})


def _pipeline_reference(model, cfg, mbs) -> tuple:
    """The port's monolithic autograd, microbatch by microbatch: the mean
    loss and every parameter's gradient summed into float32."""
    from repro_torch.models import loss_fn

    names, params = zip(*model.named_parameters())
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
    loss = torch.zeros((), dtype=torch.float32, device=params[0].device)
    for mb in mbs:
        lm, _ = loss_fn(model, mb, cfg)
        for acc, g in zip(grads, torch.autograd.grad(lm / len(mbs), params)):
            acc.add_(g)
        loss += lm.detach().float() / len(mbs)
    return loss, dict(zip(names, grads))


def _pipeline_case(dev, dtype: str, n_layers: int, timed: bool) -> dict:
    """deepseek-7b at full width, ``n_layers`` deep, as ``PIPE_STAGES``
    stages on as many ``cuda`` workers; each schedule's loss and gradients
    against the monolithic autograd (each leaf within PIPE_TOL of its
    largest |gradient|), exact launch counts; with ``timed`` a second run
    timed (wall, peak memory, the bubble from ``trace_metrics``) and a
    third profiled (device busy share)."""

    from repro_torch.configs import get_config
    from repro_torch.core import SpComputeEngine, SpWorkerTeam, trace_metrics
    from repro_torch.models import init_params, set_trainable
    from repro_torch.runtime.pipeline import model_stages, named_grads, pipeline_value_and_grad

    cfg = get_config("deepseek-7b").replace(n_layers=n_layers, dtype=dtype, remat="none")
    model = set_trainable(init_params(cfg, 0, device=dev))
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (PIPE_MB, PIPE_SEQ + 1), generator=gen, device=dev, dtype=torch.int32)
    assert 0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab, "token ids out of range"
    mbs = [{"x": tokens[m:m + 1, :-1], "tokens": tokens[m:m + 1, :-1], "labels": tokens[m:m + 1, 1:]}
           for m in range(PIPE_MB)]
    ref_loss, ref = _pipeline_reference(model, cfg, mbs)
    stage_fns, stage_params, head_fn, head_params = model_stages(model, cfg, PIPE_STAGES)
    tol = PIPE_TOL[dtype]
    ops = _kernel_ops()
    want = _pipeline_launches(cfg)
    eng = SpComputeEngine(SpWorkerTeam(["cuda"] * PIPE_STAGES))
    out = {"launches": dict.fromkeys(ops, 0), "layers": n_layers, "dtype": dtype,
           "resident_bytes": torch.cuda.memory_allocated()}  # the weights and the reference's gradients

    def run(schedule):
        return pipeline_value_and_grad(stage_fns, head_fn, stage_params, head_params, mbs, eng,
                                       schedule=schedule)

    try:
        for schedule in ("1f1b", "fifo"):
            # ---- the main path: counts from 0 just before, read just after ----
            for c in ops.values():
                c.reset()
            loss, g_stages, g_head, tg = run(schedule)
            torch.cuda.synchronize()
            launches = {k: c.count for k, c in ops.items()}
            # -------------------------------------------------------------------
            got = named_grads(g_stages, g_head, n_layers)
            assert set(got) == set(ref), sorted(set(got) ^ set(ref))
            worst = max(float((got[n] - r).abs().max() / r.abs().max().clamp_min(1e-30)) for n, r in ref.items())
            loss_err = abs(float(loss) - float(ref_loss))
            assert torch.isfinite(loss) and loss_err <= tol * abs(float(ref_loss)), (float(loss), float(ref_loss))
            assert worst <= tol, f"{schedule}: a gradient is {worst:.3e} of its leaf's max from the monolithic one"
            assert launches == want, f"{schedule}: launches {launches}, expected {want}"
            for k, v in launches.items():
                out["launches"][k] += v
            rec = dict(loss=float(loss), ref_loss=float(ref_loss), worst_share=worst, launches=launches)
            del g_stages, g_head, got
            if timed:
                tg = None
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                _, gs, gh, tg = run(schedule)
                torch.cuda.synchronize()
                rec["wall_ms"] = (time.perf_counter() - t0) * 1e3
                rec["peak_bytes"] = torch.cuda.max_memory_allocated()
                m = trace_metrics(tg)
                rec["bubble"] = 1.0 - m["utilization"]
                rec["span_ms"] = m["span_s"] * 1e3
                del gs, gh, tg
                gc.collect()
                with device_trace() as prof:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _, gs, gh, _ = run(schedule)
                    torch.cuda.synchronize()
                    prof_ms = (time.perf_counter() - t0) * 1e3
                del gs, gh
                rec["device"] = _device_rows(prof, prof_ms, 1)
            out[schedule] = rec
            log(f"[pipeline] deepseek-7b {n_layers} layers {dtype}, {PIPE_STAGES} stages x {PIPE_MB} microbatches "
                f"of (1, {PIPE_SEQ}), {schedule}: loss {float(loss):.6f} (monolithic {float(ref_loss):.6f}), "
                f"worst gradient {worst:.3e} of its leaf's max (limit {tol}); launches {launches}"
                + (f"; wall {rec['wall_ms']:.1f} ms, bubble {rec['bubble']:.3f} (host-side task spans, "
                   f"{rec['span_ms']:.1f} ms), device busy {rec['device']['busy']:.3f} "
                   f"({rec['device']['device_ms']:.1f} ms in {rec['device']['profiled_wall_ms']:.1f} ms profiled), "
                   f"peak {rec['peak_bytes'] / 2**30:.2f} GiB (weights and the reference's gradients "
                   f"{out['resident_bytes'] / 2**30:.2f} GiB); device time by kind "
                   + ", ".join(f"{k} {v:.1f} ms" for k, v in rec["device"]["kinds"]) if timed else ""))
    finally:
        eng.stop()
    del model, ref, stage_params, head_params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pipeline_phase(dev) -> dict:
    """15. ``runtime.pipeline`` on the card: deepseek-7b at full width as 4
    stages on 4 ``cuda`` worker threads, 4 microbatches of (1, 2048), under
    1F1B and FIFO; fp32 at a cut depth first, then bf16 at PIPE_LAYERS."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    f32 = _pipeline_case(dev, "float32", PIPE_FP32_LAYERS, timed=False)
    bf16 = _pipeline_case(dev, "bfloat16", PIPE_LAYERS, timed=True)
    launches = {k: f32["launches"][k] + bf16["launches"][k] for k in f32["launches"]}
    return dict(fp32=f32, bf16=bf16, launches=launches, seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# 16. chaos soak on the card
# ---------------------------------------------------------------------------

CHAOS_SEEDS = 3
CHAOS_ITERS = 20


def chaos_phase(dev) -> dict:
    """16. ``dist.chaos`` with every group and payload on the card: ring
    all-reduce under link faults over a hub and over 3 and 2 socket ranks
    (bit-exact each iteration), a rank dying under the elastic loop, and
    the serve engine (reduced deepseek-7b) under deadlines, cancels and
    preemptions, its flash / decode / rmsnorm launches exact (counted over
    the serve runs)."""
    from repro_torch.configs import reduced_config
    from repro_torch.dist import chaos

    out = {"launches": dict.fromkeys(_kernel_ops(), 0)}
    t_all = time.perf_counter()
    runs = [("collectives", chaos.chaos_collectives, {}), ("collectives_p2p", chaos.chaos_collectives_p2p, {}),
            ("collectives_p2p", chaos.chaos_collectives_p2p, {"size": 2}), ("elastic", chaos.chaos_elastic, {}),
            ("serve", chaos.chaos_serve, {})]
    ops = _kernel_ops()
    cfg = reduced_config("deepseek-7b")
    for name, fn, kw in runs:
        for seed in range(CHAOS_SEEDS):
            if name == "serve":
                # ---- the main path: counts from 0 just before, read just after ----
                for c in ops.values():
                    c.reset()
            t0 = time.perf_counter()
            stats = fn(seed, CHAOS_ITERS, device=COMM_DEVICE, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if name == "serve":
                launches = {k: c.count for k, c in ops.items()}
                # -------------------------------------------------------------------
                want = _serve_launches(cfg, prefills=stats["prefills"], decode_steps=stats["decode_steps"])
                assert launches == want, f"chaos serve seed {seed}: launches {launches}, expected {want}"
                assert stats["requests"] == stats["completed"] + stats["deadline_shed"] + stats["shed"] \
                    + stats["cancels"] + stats["cancelled_q"], stats
                assert all(launches[k] > 0 for k in ("flash_attention", "decode_attention", "rmsnorm")), launches
                for k, v in launches.items():
                    out["launches"][k] += v
            key = f"{name}{kw.get('size', '')}/seed{seed}"
            out[key] = dict(stats, seconds=dt)
            log(f"[chaos] {name}{' size ' + str(kw['size']) if kw else ''} seed {seed}, {CHAOS_ITERS} iterations "
                f"on the card: {dt:.2f} s; {stats}")
    out["seconds"] = time.perf_counter() - t_all
    log(f"[chaos] {CHAOS_SEEDS} seeds x {CHAOS_ITERS} iterations of every scenario on the card passed in "
        f"{out['seconds']:.1f} s; serve launches {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# 17. the device mesh: axis= collectives, hierarchical_psum, data parallel
# ---------------------------------------------------------------------------

MESH_N = 1 << 24  # float32 elements a collective


def _mesh_gloo_rank(n: int) -> dict:
    """One rank of a (2, 2) pod × data gloo mesh (CPU tensors): the axis=
    collectives and hierarchical_psum against the flat sums, bit for bit;
    whether gloo takes CUDA tensors for all_reduce and reduce_scatter here
    (recorded, not required); then the data-parallel train steps
    (``launch.mesh.dp_train``)."""
    from repro_torch.launch.mesh import dp_train

    import torch.distributed as dist

    from repro_torch.dist import collectives as coll
    from repro_torch.dist.sharding import current_mesh

    mesh = current_mesh()
    rank = dist.get_rank()
    xs = [(torch.arange(n, dtype=torch.float32) % 13.0) + 7.0 * (r + 1) for r in range(4)]
    x = xs[rank]
    pod, data = mesh.get_local_rank("pod"), mesh.get_local_rank("data")
    same_pod = [r for r in range(4) if r // 2 == pod]
    checks = {
        "sum data": (coll.all_reduce(x, axis="data"), sum(xs[r] for r in same_pod)),
        "mean pod x data": (coll.all_reduce(x, axis=("pod", "data"), op="mean"), sum(xs) / 4),
        "gather data": (coll.all_gather(x, axis="data"), torch.stack([xs[r] for r in same_pod])),
        "hierarchical": (coll.hierarchical_psum(x), sum(xs)),
    }
    bad = [k for k, (got, want) in checks.items() if not torch.equal(got, want)]
    cuda = {}
    for what in ("all_reduce", "reduce_scatter"):
        try:
            t = torch.ones(8, device="cuda") * (rank + 1)
            if what == "all_reduce":
                dist.all_reduce(t)
                cuda[what] = bool(torch.equal(t.cpu(), torch.full((8,), 10.0)))
            else:
                piece = torch.empty(2, device="cuda")
                dist.reduce_scatter_tensor(piece, t)
                cuda[what] = bool(torch.equal(piece.cpu(), torch.full((2,), 10.0)))
        except Exception as e:  # recorded: the probe asks what this build's gloo takes
            cuda[what] = f"refused: {type(e).__name__}: {str(e).splitlines()[0][:120]}"
    return {"bad": bad, "cuda": cuda, "dp": dp_train("cpu")}


def _mesh_nccl(dev) -> dict:
    """A one-rank NCCL group on the card: the axis= collectives and
    hierarchical_psum on a (1, 1) pod × data mesh (each the input, bit for
    bit, timed), then ``launch.mesh.DP_STEPS`` data-parallel train steps of reduced
    deepseek-7b on that mesh, bit for bit the off-mesh steps, launch counts
    exact."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import reduced_config
    from repro_torch.dist import collectives as coll
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.mesh import DP_STEPS, dp_train, join_group

    out = {}
    x = (torch.arange(MESH_N, device=dev, dtype=torch.float32) % 251.0) + 3.0
    off = dp_train(dev)  # one process, off-mesh
    ops = _kernel_ops()
    join_group(0, 1, "nccl")
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("pod", "data"))
        with use_mesh(mesh):
            for name, fn, want in (("all_reduce sum", lambda: coll.all_reduce(x, axis="data"), x),
                                   ("all_reduce mean", lambda: coll.all_reduce(x, axis=("pod", "data"), op="mean"), x),
                                   ("all_gather", lambda: coll.all_gather(x, axis="pod"), x[None]),
                                   ("hierarchical_psum", lambda: coll.hierarchical_psum(x), x)):
                got = fn()
                assert got.device == x.device and torch.equal(got, want), name
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                out[name] = (time.perf_counter() - t0) / 5 * 1e3
            # ---- the main path: counts from 0 just before, read just after ----
            for c in ops.values():
                c.reset()
            t0 = time.perf_counter()
            on = dp_train(dev)
            torch.cuda.synchronize()
            on_s = time.perf_counter() - t0
            launches = {k: c.count for k, c in ops.items()}
            # -------------------------------------------------------------------
    finally:
        dist.destroy_process_group()
    # dp_train's config: reduced deepseek-7b in float32 (the wide routes)
    want = {k: v * DP_STEPS
            for k, v in _train_launches_per_step(reduced_config("deepseek-7b").replace(dtype="float32"), 1).items()}
    assert launches == want, f"mesh train steps: launches {launches}, expected {want}"
    assert on["losses"] == off["losses"] and on["grad_norms"] == off["grad_norms"], \
        (on["losses"], off["losses"], on["grad_norms"], off["grad_norms"])
    same = all(np.array_equal(on["params"][n], p) for n, p in off["params"].items())
    assert same, "the one-rank mesh step differs from the off-mesh step"
    log(f"[mesh] one-rank NCCL group, (1, 1) pod x data mesh on the card: {MESH_N} float32 a call, each "
        "collective bit for bit its input; ms a call " + ", ".join(f"{k} {v:.3f}" for k, v in out.items())
        + f"; {DP_STEPS} data-parallel train steps of reduced deepseek-7b bit for bit the off-mesh steps "
        f"(losses {on['losses']}), {on_s:.2f} s with the first-call set-up; launches {launches}")
    return dict(collective_ms=out, losses=on["losses"], launches=launches)


def mesh_phase(dev) -> dict:
    """17. The device mesh: (a) a one-rank NCCL group on the card; (b) gloo
    rank processes (CPU tensors) — the axis= collectives and
    hierarchical_psum at 4 ranks on a (2, 2) pod × data mesh, the
    data-parallel step at 2 (data) and 4 (pod × data) ranks against one
    process's step (within 1e-6), and whether gloo takes CUDA tensors.
    Multi-card NCCL needs more than this machine's one card."""
    from repro_torch.launch import mesh as launch_mesh

    t_all = time.perf_counter()
    out = {"nccl": _mesh_nccl(dev)}
    one = launch_mesh.dp_train("cpu")
    for size, shape, axes in ((4, (2, 2), ("pod", "data")), (2, (2,), ("data",))):
        t0 = time.perf_counter()
        if size == 4:
            res = launch_mesh.spawn_mesh(_mesh_gloo_rank, 4, shape, axes, 1001, timeout=300.0)
            assert all(not r["bad"] for r in res), [r["bad"] for r in res]
            out["gloo_cuda"] = res[0]["cuda"]
            log(f"[mesh] 4 gloo processes, (2, 2) pod x data: the axis= collectives and hierarchical_psum bit "
                f"for bit the flat sums; gloo with CUDA tensors: {res[0]['cuda']}")
            ranks = [r["dp"] for r in res]
        else:
            ranks = launch_mesh.spawn_mesh(functools.partial(launch_mesh.dp_train, "cpu"), size, shape, axes,
                                           timeout=300.0)
        dt = time.perf_counter() - t0
        worst = max(float(np.abs(r["params"][n] - p).max()) for r in ranks for n, p in one["params"].items())
        agree = all(np.array_equal(r["params"][n], ranks[0]["params"][n]) for r in ranks for n in one["params"])
        # the optimizer and the clip do not see a constant gradient scale: the
        # grad norms show that the ranks' gradients were averaged, not summed
        gn = max(abs(g - w) / w for r in ranks for g, w in zip(r["grad_norms"], one["grad_norms"]))
        assert worst <= 1e-6 and agree and gn <= 1e-6, (size, worst, agree, gn)
        out[f"dp{size}"] = dict(worst=worst, grad_norm_rel=gn, seconds=dt)
        log(f"[mesh] {size} gloo processes {dict(zip(axes, shape))}: {launch_mesh.DP_STEPS} data-parallel steps "
            f"of reduced deepseek-7b (fp32, CPU), every rank's parameters equal, {worst:.3e} from one process's step, "
            f"grad norms {ranks[0]['grad_norms']} ({gn:.3e} relative from one process's {one['grad_norms']}); "
            f"{dt:.1f} s with start-up")
    out["launches"] = out["nccl"]["launches"]
    out["seconds"] = time.perf_counter() - t_all
    return out


# ---------------------------------------------------------------------------
# 18. the model axis: tensor-parallel training, two gloo processes on one card
# ---------------------------------------------------------------------------

TP_SEQ = 2048
TP_BATCH = 2  # in 2 microbatches: every flash call at (1, 2048, the local heads, 128)
TP_MOE = "qwen3-moe-235b-a22b"
TP_ARCHS = ("deepseek-7b", TP_MOE, "mamba2-130m", "recurrentgemma-9b", "hubert-xlarge", "internvl2-2b")
# depths (the script's time limit): deepseek-7b 2 (fp32 and bf16); qwen3-moe
# 1: its 128 experts are 4.83 GB a layer in bf16 (2.42 GB a rank), 9.66 GB in
# fp32; mamba2-130m 4 of its 24; recurrentgemma-9b one (rec, rec, attn)
# super-block; hubert-xlarge and internvl2-2b 2
TP_LAYERS = {"deepseek-7b": {"float32": 2, "bfloat16": 2}, TP_MOE: {"float32": 1, "bfloat16": 1},
             "mamba2-130m": {"float32": 4, "bfloat16": 4}, "recurrentgemma-9b": {"float32": 3, "bfloat16": 3},
             "hubert-xlarge": {"float32": 2, "bfloat16": 2}, "internvl2-2b": {"float32": 2, "bfloat16": 2}}
TP_STEPS = 2
TP_OFFSET_ATOL = 5e-7  # the fp32 norm offsets' |difference| from one process (see tp_phase)
# the leaves initialised to zero, held as the norm offsets are: the norms',
# the SSM's gated norm, the conv and RG-LRU gate biases
TP_ZERO_INIT = (".scale", ".norm", ".conv_b", ".b_a", ".b_x")
# the |difference| of a leaf whose Adafactor update is elementwise: a factored
# dim of 1 (the (D, 1, Dh) K / V weights of recurrentgemma-9b's MQA, replicated
# over model, their gradients summed) makes v = g² per element, so the update
# is lr·sign(g)·(a row's scale), as AdamW's first step is, and float noise in a
# near-zero gradient moves the weight by a share of lr: held as
# tests/test_torch_tp.py holds AdamW's parameters
TP_SIGN_ATOL = 1e-5


def _tp_cfg(dtype: str, arch: str = "deepseek-7b"):
    """``arch`` at full width and ``TP_LAYERS``' depth, Adafactor; internvl2-2b's
    loss in chunks of 256 (its 1792 text positions a sequence are no multiple
    of its 768)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).replace(n_layers=TP_LAYERS[arch][dtype], dtype=dtype, optimizer="adafactor")
    return cfg.replace(logits_chunk=256) if cfg.frontend == "vision" else cfg


def _tp_local_key(cfg) -> tuple:
    """The by-shape key of the mixer kernel's calls on a rank of a model axis
    of 2 in ``[tp]``'s microbatch: flash at the rank's heads (its KV heads
    where 2 divides them, else all), or the ssd at its 12 of 24 heads."""
    if cfg.family == "ssm":
        s = cfg.ssm
        return (1, s.expand * cfg.d_model // s.head_dim // 2, TP_SEQ // s.chunk_size, s.chunk_size, s.head_dim,
                s.n_groups, s.d_state)
    kv = cfg.n_kv_heads // 2 if cfg.n_kv_heads % 2 == 0 else cfg.n_kv_heads
    return (1, TP_SEQ, TP_SEQ, cfg.n_heads // 2, kv, cfg.head_dim, cfg.head_dim)


TIE_RTOL = 1e-4  # a flipped choice: its and the replaced choice's probabilities within this share of the largest


class _Routing:
    """Every MoE router call's ``top_i`` while active (the MoE layers look
    ``_router`` up in their module at each call): a digest of each
    (``digests``) and the arrays on the host (``top_i``).  With ``replay``
    (another run's ``top_i``, one a call) each call routes by the replayed
    choices in place of its own, their probabilities renormalised as
    ``_router`` renormalises its own, so that a run whose float sums differ
    in the last bits makes the other run's choices; ``flips`` lists each
    call whose own choices differed: (call, tokens that differ, the largest
    gap between a token's own and replayed choices' probabilities over its
    largest probability)."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        from repro_torch.models import moe as moe_mod

        self.digests, self.top_i, self.flips = [], [], []
        self.mod, self.real = moe_mod, moe_mod._router

        def router(p, xt, cfg, *rest):
            top_p, top_i, aux = self.real(p, xt, cfg, *rest)
            if self.replay is not None:
                top_p, top_i = self._replayed(p, xt, top_p, top_i)
            self.digests.append(_digest(top_i))
            self.top_i.append(top_i.cpu().numpy())
            return top_p, top_i, aux

        moe_mod._router = router
        return self

    def _replayed(self, p, xt, top_p, own):
        call = len(self.digests)
        want = torch.from_numpy(self.replay[call]).to(own.device)
        if torch.equal(want, own):
            return top_p, own
        probs = torch.softmax(xt.float() @ p.router.float(), dim=-1)  # _router's
        differ = (want != own).any(dim=-1)
        gap = (probs.gather(-1, own) - probs.gather(-1, want)).abs().amax(dim=-1) / probs.amax(dim=-1)
        self.flips.append((call, int(differ.sum()), float(gap[differ].max())))
        top_p = probs.gather(-1, want)
        return top_p / torch.clamp(torch.sum(top_p, dim=-1, keepdim=True), min=1e-9), want

    def __exit__(self, *exc):
        self.mod._router = self.real
        if self.replay is not None and exc[0] is None:
            assert len(self.digests) == len(self.replay), (len(self.digests), len(self.replay))


def _tp_run(cfg, dev) -> tuple:
    """``TP_STEPS`` staged Adafactor steps of ``cfg`` from the state seeded
    with 0 on one seeded (``TP_BATCH``, ``TP_SEQ``) batch in 2 microbatches
    (tensor-parallel under the active mesh) → (state, art, losses, grad
    norms, each step's wall ms, the batch, the steps' MoE metrics)."""
    from repro_torch.runtime.train import build_train_step, init_train_state

    from repro_torch.launch.mesh import tp_batch
    from repro_torch.models.param import DTYPES

    state = init_train_state(cfg, 0, device=dev)
    art = build_train_step(cfg, n_microbatches=2)
    if cfg.frontend is None:
        gen = torch.Generator(device=dev).manual_seed(5)
        tokens = torch.randint(0, cfg.vocab, (TP_BATCH, TP_SEQ + 1), generator=gen, device=dev, dtype=torch.int32)
        assert 0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab, "token draw out of range (F3)"
        batch = {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}
    else:  # the data pipeline's frames or patches, in the model's dtype (the dry run's inputs)
        batch = {k: v.to(DTYPES[cfg.dtype]) if v.is_floating_point() else v
                 for k, v in tp_batch(cfg, TP_BATCH, TP_SEQ, dev).items()}
    losses, norms, ms, aux = [], [], [], []
    for _ in range(TP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = art(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        aux.append({k: float(m[k]) for k in ("moe_balance", "moe_zloss") if k in m})
    return state, art, losses, norms, ms, batch, aux


def _digest(t) -> str:
    import hashlib

    return hashlib.sha1(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def _tp_rank(device: str = "cuda") -> dict:
    """One rank of the (1, 2) data × model mesh, every tensor on the card,
    for each of ``TP_ARCHS``: this process's own one-process fp32 run, off
    the mesh, first (the ranks take turns: two of qwen3-moe's, 41.76 GiB
    each at their peak, do not fit on the card together; of its parameters
    this rank keeps its parts); the fp32 run's parts against those (each
    part's worst |difference|), digests of its replicated leaves and
    Adafactor state (and, MoE, of every router call's ``top_i``); then the
    bf16 run's step ms, peak, state bytes and launch counts (all 0 just
    before each run, read just after)."""
    import torch.distributed as dist

    from repro_torch.models import Transformer
    from repro_torch.runtime.train import state_bytes

    from repro_torch.dist.sharding import use_mesh

    dev = torch.device(device)
    ops = _kernel_ops()
    out = {"rank": dist.get_rank()}
    for arch in TP_ARCHS:
        index = {n: sh.index for n, sh in Transformer(_tp_cfg("float32", arch), device="meta").shards.items()}
        for turn in range(dist.get_world_size()):
            if turn == dist.get_rank():
                with use_mesh(None):
                    one = _tp_reference(arch, dev, index)
            dist.barrier()
        ref = one.pop("params")
        out[arch] = {"one": one}
        for dtype in ("float32", "bfloat16"):
            cfg = _tp_cfg(dtype, arch)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()  # what the run before left allocated
            for c in ops.values():
                c.reset()
            # ---- the main path: counts from 0 just before, read just after ----
            # fp32: a digest of each MoE router call's top_i (the bf16 runs are timed without)
            with _Routing() if dtype == "float32" else contextlib.nullcontext() as routing:
                state, art, losses, norms, ms, batch, aux = _tp_run(cfg, dev)
            launches = {k: c.count for k, c in ops.items()}
            by_shape = {k: dict(c.by_shape) for k, c in ops.items() if c.count}
            # -------------------------------------------------------------------
            sb = state_bytes(state, art)
            nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
            r = dict(losses=losses, grad_norms=norms, aux=aux, step_ms=ms, launches=launches, by_shape=by_shape,
                     peak=torch.cuda.max_memory_allocated(), base=base, bytes=sb,
                     routing=getattr(routing, "digests", []),
                     arg_bytes=sb["params"] + sb["opt"] + nbytes([state.step]) + nbytes(batch.values()))
            model = state.params
            if dtype == "float32":
                r["err"], r["digests"] = {}, {}
                for name, p in model.named_parameters():
                    sh = model.shards[name]
                    r["err"][name] = float((p.detach() - ref[name]).abs().max())
                    if not sh.sharded:
                        r["digests"][name] = _digest(p)
                for path, leaf in state.opt.items():
                    for k, v in leaf.items():
                        r["digests"][f"opt {path}/{k}"] = _digest(v)
                del ref
            out[arch][dtype] = r
            del state, art, model
            gc.collect()
    gc.collect()
    torch.cuda.empty_cache()
    out["serve"] = _tps_rank(device)  # [tp-serve]'s runs, in the same process group
    return out


def _tp_reference(arch: str, dev, index: dict) -> dict:
    """The off-mesh fp32 run of ``arch`` on the card → losses, grad norms,
    MoE metrics, each leaf's largest magnitude and each parameter's part at
    ``index[name]`` (the rest of the state freed)."""
    cfg = _tp_cfg("float32", arch)
    torch.cuda.reset_peak_memory_stats()
    base, t0 = torch.cuda.memory_allocated(), time.perf_counter()
    state, art, losses, norms, _, _, aux = _tp_run(cfg, dev)
    params = {name: p.detach() for name, p in state.params.named_parameters()}
    leaf_max = {name: float(p.abs().max()) for name, p in params.items()}
    sign_like = [name for name, p in params.items() if p.dim() >= 2 and p.shape[-2] == 1]
    params = {name: p[index[name]].clone() for name, p in params.items()}
    del state, art
    gc.collect()
    torch.cuda.empty_cache()
    kept = sum(p.numel() * p.element_size() for p in params.values())
    log(f"[tp] {arch} fp32 one-process reference: {time.perf_counter() - t0:.1f} s, peak "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB allocated "
        f"before it, parts of the parameters kept {kept / 2**30:.2f} GiB")
    return dict(losses=losses, grad_norms=norms, aux=aux, leaf_max=leaf_max, params=params, sign_like=sign_like)


def _tp_check_fp32(arch: str, one: dict, f32: list) -> dict:
    """Each rank's fp32 run against the one process's: losses, grad norms
    (and MoE metrics) within 1e-5 relative, every weight's parts within
    1e-5 of its leaf's max and the norm offsets' within ``TP_OFFSET_ATOL``,
    replicated leaves, the Adafactor state and every router call's
    ``top_i`` the same bits on both ranks."""
    for r in f32:
        pairs = [(r["losses"], one["losses"], "loss"), (r["grad_norms"], one["grad_norms"], "grad norm")]
        pairs += [([a[k] for a in r["aux"]], [a[k] for a in one["aux"]], k) for k in (r["aux"][0] if r["aux"] else {})]
        for got, want, what in pairs:
            rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
            assert rel <= 1e-5, f"[tp] {arch} fp32 {what} {got} against one process's {want} ({rel:.2e} relative)"
    # every weight within 1e-5 of its leaf's max.  The norm offsets (and the
    # other zero-initialised leaves, TP_ZERO_INIT) start at zero, so their
    # values are the two updates; Adafactor factors a stacked
    # (layers, D) offset leaf over its layers (at 1 layer it does not
    # factor), which normalises each column's update over those values: a
    # sign-like step that turns float noise in a near-zero gradient into a
    # share of the step, as AdamW's does (tests/test_torch_tp.py).  They are
    # held within TP_OFFSET_ATOL absolute, about three times the worst
    # difference read on the H100 for deepseek-7b (1.46e-7, on values of
    # 1.64e-3 at most).
    leaf_max = one["leaf_max"]
    err = {n: max(r["err"][n] for r in f32) for n in leaf_max}
    offsets = [n for n in leaf_max if n.endswith(TP_ZERO_INIT)]
    sign_like = [n for n in one["sign_like"] if n not in offsets]
    worst = {n: err[n] / max(leaf_max[n], 1e-30) for n in leaf_max if n not in offsets and n not in sign_like}
    worst_name = max(worst, key=worst.get)
    worst_offset = max(offsets, key=err.get)
    top = sorted(leaf_max, key=lambda n: -err[n] / max(leaf_max[n], 1e-30))[:4]
    log(f"[tp] {arch} fp32 worst leaves (|difference| / the leaf's max, |difference|): " + ", ".join(
        f"{n} {err[n] / max(leaf_max[n], 1e-30):.2e} {err[n]:.2e}" for n in top))
    assert worst[worst_name] <= 1e-5, f"[tp] {arch} fp32 {worst_name}: {worst[worst_name]:.2e} of its leaf's max"
    assert err[worst_offset] <= TP_OFFSET_ATOL, \
        f"[tp] {arch} fp32 {worst_offset}: {err[worst_offset]:.2e} from one process"
    if sign_like:
        worst_sign = max(sign_like, key=err.get)
        log(f"[tp] {arch} fp32 leaves with an elementwise Adafactor update: worst {worst_sign} {err[worst_sign]:.2e} "
            f"(limit {TP_SIGN_ATOL}; its max {leaf_max[worst_sign]:.2e})")
        assert err[worst_sign] <= TP_SIGN_ATOL, f"[tp] {arch} fp32 {worst_sign}: {err[worst_sign]:.2e} from one process"
    assert f32[0]["digests"] == f32[1]["digests"], \
        [k for k in f32[0]["digests"] if f32[0]["digests"][k] != f32[1]["digests"].get(k)]
    assert f32[0]["routing"] == f32[1]["routing"], f"[tp] {arch}: the ranks routed differently"
    return dict(worst_name=worst_name, worst=worst[worst_name], worst_offset=worst_offset,
                offset_err=err[worst_offset], offset_max=leaf_max[worst_offset])


def tp_phase(dev) -> dict:
    """18. The ``model`` mesh axis on one card: two gloo rank processes on
    a (1, 2) data × model mesh sharing the card (``_tp_rank``), each
    making its own one-process fp32 runs off the mesh: deepseek-7b,
    qwen3-moe (expert parallelism: 64 of its 128 experts a rank),
    mamba2-130m (the SSD on 12 of 24 heads), recurrentgemma-9b (the RG-LRU
    width and windowed MQA), hubert-xlarge and internvl2-2b (the
    frontends), fp32 against the one process, bf16 timed and counted.  One
    process group, which then runs ``[tp-serve]``'s serving runs
    (``_tps_rank``; checked by ``tp_serve_phase``): a group takes ~20 s to
    start."""
    from repro_torch.launch import mesh as launch_mesh

    t_all = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    ranks = launch_mesh.spawn_mesh(_tp_rank, 2, (1, 2), ("data", "model"), str(dev), timeout=900.0)
    spawn_s = time.perf_counter() - t0
    serve_ranks = [r.pop("serve") for r in ranks]
    out = dict(serve_ranks=serve_ranks, launches_by_shape={}, arch={})
    launches: dict = {}
    one = {}
    for arch in TP_ARCHS:  # both ranks ran the same one-process reference
        a, b = (r[arch].pop("one") for r in ranks)
        assert (a["losses"], a["grad_norms"]) == (b["losses"], b["grad_norms"]), f"[tp] {arch}: references differ"
        one[arch] = a
    for arch in TP_ARCHS:
        f32 = [r[arch]["float32"] for r in ranks]
        chk = _tp_check_fp32(arch, one[arch], f32)
        cfg32, cfg16 = _tp_cfg("float32", arch), _tp_cfg("bfloat16", arch)
        want32 = {k: v * TP_STEPS for k, v in _train_launches_per_step(cfg32, 2).items()}
        for r in f32:
            assert r["launches"] == want32, f"[tp] {arch} fp32 launches {r['launches']}, expected {want32}"
        log(f"[tp] {arch} fp32, full width, {cfg32.n_layers} layers, 2 gloo ranks on one card (data 1 x model 2): "
            f"losses {f32[0]['losses']} / {f32[1]['losses']}, one process {one[arch]['losses']}; grad norms "
            f"{f32[0]['grad_norms']}, one process {one[arch]['grad_norms']}"
            + (f"; MoE metrics {f32[0]['aux']}, one process {one[arch]['aux']}; every router call's top_i the same "
               f"bits on both ranks ({len(f32[0]['routing'])} calls)" if f32[0]["routing"] else "")
            + f"; worst weight {chk['worst_name']} {chk['worst']:.2e} of its max, worst norm offset "
            f"{chk['worst_offset']} {chk['offset_err']:.2e} (values {chk['offset_max']:.2e} at most); "
            f"{len(f32[0]['digests'])} replicated leaves and Adafactor state tensors the same bits on both ranks; "
            f"launches a rank {f32[0]['launches']}; peak a rank {[round(r['peak'] / 2**30, 2) for r in f32]} GiB "
            f"({[round(r['base'] / 2**30, 2) for r in f32]} GiB of it allocated before the run)")
        # bf16: times, memory, exact launch counts
        b16 = [r[arch]["bfloat16"] for r in ranks]
        want16 = {k: v * TP_STEPS for k, v in _train_launches_per_step(cfg16, 2).items()}
        local_key = _tp_local_key(cfg16)
        mixer = ("ssd", "ssd_bwd") if cfg16.family == "ssm" else ("flash_attention", "flash_attention_bwd")
        for r in b16:
            assert all(np.isfinite(r["losses"])), r["losses"]
            assert r["launches"] == want16, f"[tp] {arch} bf16 launches {r['launches']}, expected {want16}"
            for kind in mixer:
                assert r["by_shape"][kind] == {local_key: want16[kind]}, (arch, kind, r["by_shape"][kind])
        for i, r in enumerate(b16):
            log(f"[tp] {arch} bf16, {cfg16.n_layers} layers, rank {i}: step ms {[round(x, 2) for x in r['step_ms']]}, "
                f"losses {r['losses']}, peak {r['peak'] / 2**30:.2f} GiB ({r['base'] / 2**30:.2f} GiB of it "
                f"allocated before the run), state bytes {r['bytes']} (params + grads + opt "
                f"{sum(r['bytes'].values()) / 2**30:.3f} GiB), launches {r['launches']} (every {mixer[0]} call at "
                f"{local_key})")
        for k in want16:
            launches[k] = launches.get(k, 0) + sum(r[arch][dt]["launches"][k] for r in ranks for dt in ("float32",
                                                                                                            "bfloat16"))
        for r in ranks:
            for dt in ("float32", "bfloat16"):
                for kern, shapes in r[arch][dt]["by_shape"].items():
                    got = out["launches_by_shape"].setdefault(kern, {})
                    for key, c in shapes.items():
                        got[key] = got.get(key, 0) + c
        out["arch"][arch] = dict(fp32_worst=chk["worst"], fp32_offset=chk["offset_err"],
                                 step_ms=[r["step_ms"] for r in b16], peak=[r["peak"] for r in b16],
                                 base=[r["base"] for r in b16], bytes=[r["bytes"] for r in b16],
                                 arg_bytes=[r["arg_bytes"] for r in b16],
                                 flash_per_step=want16["flash_attention"] // TP_STEPS,
                                 flash_bwd_per_step=want16["flash_attention_bwd"] // TP_STEPS)
    seconds = time.perf_counter() - t_all
    log(f"[tp] {seconds:.1f} s, the rank processes {spawn_s:.1f} s with start-up")
    dense = out["arch"]["deepseek-7b"]
    return dict(out, launches=launches, seconds=seconds, fp32_worst=dense["fp32_worst"], step_ms=dense["step_ms"],
                moe_step_ms=out["arch"][TP_MOE]["step_ms"])


# ---------------------------------------------------------------------------
# 19. the model axis: dense serving, two gloo processes on one card
# ---------------------------------------------------------------------------

TPS_PROMPTS = (2048, 777, 100, 321)  # [serve]'s ragged prompts and its sampled one
TPS_MAX_SEQ = MAX_SEQ
TPS_STEPS = 16
TPS_LAYERS = 4
TPS_MLA = "minicpm3-4b"
# (arch, dtype, kv_shard) of each serving run on the mesh; the bf16 deepseek-7b
# run is profiled
# the recurrent models: 8 slots of prompts to 4096 tokens, so recurrentgemma-9b's
# 2048-slot ring wraps (1024 slots a rank); internvl2-2b: its 256 patches before
# each prompt's text; depths: mamba2-130m 4, recurrentgemma-9b one super-block,
# internvl2-2b 2
TPS_REC_PROMPTS = (4096, 2500, 2048, 777, 100, 321, 1031, 131)
TPS_REC_MAX_SEQ = 4096 + 256
TPS_IVL_TEXT = (1792, 521, 100, 65)
TPS_NEW = ("mamba2-130m", "recurrentgemma-9b", "internvl2-2b")
TPS_LAYERS_OF = {"mamba2-130m": 4, "recurrentgemma-9b": 3, "internvl2-2b": 2}
TPS_RUNS = (("deepseek-7b", "float32", "seq"), ("deepseek-7b", "float32", "heads"), ("deepseek-7b", "bfloat16", "seq"),
            (TP_MOE, "float32", "seq"), (TP_MOE, "bfloat16", "seq"),
            (TPS_MLA, "float32", "seq"), (TPS_MLA, "bfloat16", "seq")) + tuple(
    (arch, dtype, "seq") for arch in TPS_NEW for dtype in ("float32", "bfloat16"))
TPS_ARCHS = ("deepseek-7b", TP_MOE, TPS_MLA) + TPS_NEW
TPS_PROFILED = 2  # decode steps under the profiler (bf16)
TPS_LOGIT_RTOL = 1e-5  # fp32 logits against one process's, of the row's largest magnitude


def _tps_cfg(dtype: str, kv_shard: str = "seq", arch: str = "deepseek-7b"):
    from repro_torch.configs import get_config

    return get_config(arch).replace(n_layers=TPS_LAYERS_OF.get(arch, TPS_LAYERS), dtype=dtype, kv_shard=kv_shard)


def _tps_prompts(cfg) -> tuple:
    """(each prompt's positions, the caches' rows) of ``cfg``'s serving run:
    ``TPS_REC_PROMPTS`` into ``TPS_REC_MAX_SEQ`` rows for the recurrent
    models, internvl2-2b's patches and ``TPS_IVL_TEXT``, else ``TPS_PROMPTS``."""
    if cfg.family in ("ssm", "hybrid"):
        return TPS_REC_PROMPTS, TPS_REC_MAX_SEQ
    if cfg.frontend == "vision":
        return tuple(cfg.n_patches + t for t in TPS_IVL_TEXT), TPS_MAX_SEQ
    return TPS_PROMPTS, TPS_MAX_SEQ


def _tps_run_name(arch: str, dtype: str, kv_shard: str) -> str:
    return f"{arch}-{dtype}-{kv_shard}"


def _tps_shape(cfg=None):
    from repro_torch.models import ShapeSpec

    prompts, max_seq = _tps_prompts(cfg) if cfg is not None else (TPS_PROMPTS, TPS_MAX_SEQ)
    return ShapeSpec("tp-serve", "decode", max_seq, len(prompts))


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _tps_run(cfg, dev, profile: bool = False, replay=None) -> dict:
    """Greedy serving of ``cfg`` from the weights seeded with 0
    (tensor-parallel under the active mesh, one process off it): the
    ``TPS_PROMPTS`` prompts (seeded) prefilled one by one
    (``build_prefill_fn``), primed (``prime_cache``) into a pool of 4 slots
    of ``TPS_MAX_SEQ`` rows (``init_cache``), then ``TPS_STEPS`` greedy
    ``build_serve_step`` steps at each slot's position.  Launch counts are
    0 just before and read just after that main path; then one more decode
    step gives the whole logits, one step's memory is read, and with
    ``profile`` ``TPS_PROFILED`` steps run under the profiler.  fp32
    records every MoE router call's ``top_i`` and, with ``replay`` (the
    ranks' ``top_i``), routes by it (``_Routing``)."""
    from repro_torch.models import decode_step, gather_logits, init_cache, init_params
    from repro_torch.models.param import DTYPES
    from repro_torch.runtime.serve import build_prefill_fn, build_serve_step, prime_cache

    ops = _kernel_ops()
    model = init_params(cfg, 0, device=dev)
    gen = torch.Generator().manual_seed(7)
    lens, max_seq = _tps_prompts(cfg)
    n_patches = cfg.n_patches if cfg.frontend == "vision" else 0
    prompts = []
    for L in lens:
        b = {"tokens": torch.randint(0, cfg.vocab, (1, L - n_patches), generator=gen, dtype=torch.int32).to(dev)}
        if n_patches:
            b["patch_embeds"] = torch.randn((1, n_patches, 1024), generator=gen).to(dev, DTYPES[cfg.dtype])
        prompts.append(b)
    prefill_fn = build_prefill_fn(cfg)
    step = build_serve_step(cfg, _tps_shape(cfg))
    caches = init_cache(cfg, len(prompts), max_seq, device=dev)
    pos = torch.tensor(lens, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for c in ops.values():
        c.reset()
    # ---- the main path: counts from 0 just before, read just after ----
    t0 = time.perf_counter()
    first = []
    # fp32: each MoE router call's top_i (the bf16 runs are timed without)
    with _Routing(replay) if cfg.dtype == "float32" else contextlib.nullcontext() as routing:
        for b, (prompt, L) in enumerate(zip(prompts, lens)):
            tok, pc = prefill_fn(model, prompt)
            primed = prime_cache(cfg, pc, L, max_seq)
            for name in caches:
                caches[name][:, b:b + 1] = primed[name]
            first.append(tok)
            del pc, primed
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        tok, toks, step_ms = torch.cat(first), [], []
        toks.append(tok)
        for i in range(TPS_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, caches = step(model, tok, caches, pos + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            toks.append(tok)
        launches = {k: c.count for k, c in ops.items()}
        by_shape = {k: dict(c.by_shape) for k, c in ops.items() if c.count}
        # -------------------------------------------------------------------
        peak = torch.cuda.max_memory_allocated()
        arg_bytes = _nbytes(model.parameters()) + _nbytes([tok, pos]) + _nbytes(caches.values())
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        lg, _ = decode_step(model, tok, caches, pos + TPS_STEPS, cfg)
        logits = gather_logits(model, lg)[:, 0].float().cpu().numpy()
        step_temp = torch.cuda.max_memory_allocated() - before
    out = dict(tokens=torch.cat(toks, dim=1).cpu().numpy(), step_ms=step_ms, prefill_ms=prefill_ms,
               launches=launches, by_shape=by_shape, peak=peak, base=base, arg_bytes=arg_bytes,
               step_temp=step_temp, logits=logits, cache_shapes={k: tuple(v.shape) for k, v in caches.items()},
               routing=getattr(routing, "digests", []), top_i=getattr(routing, "top_i", []),
               flips=getattr(routing, "flips", []))
    if profile:
        with device_trace() as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for j in range(TPS_PROFILED):
                step(model, tok, caches, pos + TPS_STEPS + 1 + j)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / TPS_PROFILED
        out["profile"] = _device_rows(prof, wall, TPS_PROFILED)
    return out


TPS_COLL_ITERS = 50  # calls timed of each of a decode step's collectives
TPS_ENCODE = (2, 2048)  # hubert-xlarge's encode on the axis: frames, fp32 at 2 layers
TPS_ENCODE_RTOL = 1e-5  # its logits against one process's, of the largest magnitude


def _tps_encode(dev) -> np.ndarray:
    """hubert-xlarge's serving call, fp32 at 2 layers, full width, from the
    weights seeded with 0: the encoder forward and the head over
    ``TPS_ENCODE`` seeded frames, every 4th masked (``_encode``), the logits
    put together over ``model`` on the active mesh (one process off it)."""
    from repro_torch.configs import get_config
    from repro_torch.models import gather_logits, init_params

    cfg = get_config("hubert-xlarge").replace(n_layers=2, dtype="float32")
    model = init_params(cfg, 0, device=dev)
    logits = gather_logits(model, _encode(model, _audio_batch(cfg, *TPS_ENCODE, dev, seed=9), cfg))
    return logits.cpu().numpy()


def _tps_collective_ms(dev) -> dict:
    """Host ms of one call of each collective a bf16 decode step makes on
    the ``model`` group (the shapes of deepseek-7b's step at 4 slots): the
    q / k / v all-gather, the (out, lse) all-gather, an activation sum and
    the greedy argmax's all-gather; median of ``TPS_COLL_ITERS``."""
    from repro_torch.dist.collectives import model_all_gather, model_sum_
    from repro_torch.dist.sharding import current_mesh

    group = current_mesh().get_group("model")
    B, H, Dh, D = len(TPS_PROMPTS), 32, 128, 4096
    calls = {"qkv all-gather": lambda: model_all_gather(torch.zeros(B, 1, 3 * H // 2, Dh, dtype=torch.bfloat16,
                                                                    device=dev), group),
             "(out, lse) all-gather": lambda: model_all_gather(torch.zeros(B, H, Dh + 1, device=dev), group),
             "activation sum": lambda: model_sum_(torch.zeros(B, 1, D, dtype=torch.bfloat16, device=dev), group),
             "argmax all-gather": lambda: model_all_gather(torch.zeros(B, 1, 2, dtype=torch.float64, device=dev),
                                                           group)}
    out = {}
    for name, fn in calls.items():
        ms = []
        for _ in range(TPS_COLL_ITERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = float(np.median(ms))
    return out


def _tps_rank(device: str = "cuda") -> dict:
    """One rank of the (1, 2) data × model mesh, every tensor on the card
    (run by ``[tp]``'s ranks, ``_tp_rank``): the ``TPS_RUNS`` serving runs
    (``_tps_run``; deepseek-7b's bf16 one profiled), then the decode step's
    collectives timed alone."""
    import torch.distributed as dist

    dev = torch.device(device)
    t0 = time.perf_counter()
    out = {"rank": dist.get_rank()}
    for arch, dtype, kv_shard in TPS_RUNS:
        profile = arch == "deepseek-7b" and dtype == "bfloat16"
        out[_tps_run_name(arch, dtype, kv_shard)] = _tps_run(_tps_cfg(dtype, kv_shard, arch), dev, profile=profile)
        gc.collect()
        torch.cuda.empty_cache()
    out["encode"] = _tps_encode(dev)
    out["collective_ms"] = _tps_collective_ms(dev)
    out["seconds"] = time.perf_counter() - t0
    return out


def _tps_decode_key(cfg, kv_shard: str):
    """The decode kernel's by-shape key on a rank of a model axis of 2: every
    head against the rank's rows (the partial route; a windowed model's
    ring slots) under ``"seq"``, the rank's heads against every row under
    ``"heads"``; None for MLA and the SSM (their decode runs in torch ops)."""
    from repro_torch.models.attention import kv_cache_shape
    from repro_torch.models.transformer import layer_cfg

    if cfg.mla is not None or cfg.family == "ssm":
        return None
    prompts, max_seq = _tps_prompts(cfg)
    B, S = len(prompts), kv_cache_shape(layer_cfg(cfg), 1, max_seq)[1]
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return (B, S // 2, H, KH, Dh, Dh, "partial") if kv_shard == "seq" else (B, S, H // 2, KH // 2, Dh, Dh)


def tp_serve_phase(dev, tp: dict) -> dict:
    """19. Serving on the ``model`` mesh axis on one card: one process's
    fp32 and bf16 runs here (``_tps_run``) against the two gloo rank
    processes' on a (1, 2) data × model mesh sharing the card
    (``_tps_rank``, run in ``[tp]``'s process group: ``tp["serve_ranks"]``):
    deepseek-7b fp32 under ``kv_shard="seq"`` (the sequence-sharded cache:
    decode's partial route and the combine) and ``"heads"``, qwen3-moe
    (expert parallelism, its GQA 64 : 4 on the partial route),
    minicpm3-4b (MLA's heads over ``model``, its latent cache by rows and
    the latent decode's combine), mamba2-130m (the whole state on every
    rank), recurrentgemma-9b (its 2048-slot ring wrapped, 1024 slots a
    rank) and internvl2-2b (its patches) fp32 under ``"seq"``, and
    hubert-xlarge's encode: each rank's tokens
    equal to one process's and its logits within ``TPS_LOGIT_RTOL`` of the
    row's largest; bf16 ``"seq"`` timed (ms a decode step; deepseek-7b's
    device-busy share), each rank's peak, exact launch counts, and its
    tokens' agreement with one process's logged."""
    t_all = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = tp["serve_ranks"]
    one = {}
    for arch in TPS_ARCHS:
        for dtype in ("float32", "bfloat16"):
            # fp32 routes by rank 0's choices: a near-tie that the ranks' float
            # sums flip would otherwise send a token to another expert
            replay = ranks[0][_tps_run_name(arch, dtype, "seq")]["top_i"] if dtype == "float32" else []
            one[(arch, dtype)] = _tps_run(_tps_cfg(dtype, arch=arch), dev, replay=replay or None)
            gc.collect()
            torch.cuda.empty_cache()
    for arch, dtype, kv_shard in TPS_RUNS:
        run = _tps_run_name(arch, dtype, kv_shard)
        cfg = _tps_cfg(dtype, kv_shard, arch)
        prompts, S = _tps_prompts(cfg)
        B = len(prompts)
        want = _serve_launches(cfg, prefills=B, decode_steps=TPS_STEPS)
        dec_key = _tps_decode_key(cfg, kv_shard)
        for r in ranks:
            got = r[run]
            assert got["launches"] == want, f"[tp-serve] {run} rank {r['rank']}: launches {got['launches']}, {want}"
            if dec_key is not None:
                assert got["by_shape"]["decode_attention"] == {dec_key: want["decode_attention"]}, \
                    (run, got["by_shape"]["decode_attention"])
            assert np.isfinite(got["logits"]).all(), run
            assert got["tokens"].min() >= 0 and got["tokens"].max() < cfg.vocab, run
        if dtype == "float32":
            base = one[(arch, "float32")]
            V = cfg.vocab  # the padding classes' -1e30 would set the scale
            scale = np.abs(base["logits"][:, :V]).max(axis=-1, keepdims=True)
            assert ranks[0][run]["routing"] == ranks[1][run]["routing"], f"[tp-serve] {run}: the ranks routed apart"
            # the one process routed by the ranks' choices; where its own
            # differed, the two experts' probabilities must be a near-tie
            flips = base["flips"]
            for r in ranks:
                got = r[run]
                assert np.array_equal(got["tokens"], base["tokens"]), \
                    f"[tp-serve] {run} rank {r['rank']}: tokens {got['tokens'].tolist()} != {base['tokens'].tolist()}"
                rel = float((np.abs(got["logits"][:, :V] - base["logits"][:, :V]) / scale).max())
                assert rel <= TPS_LOGIT_RTOL, f"[tp-serve] {run} rank {r['rank']}: logits {rel:.2e} of the row max"
                got["logit_rel"] = rel
            if base["routing"]:
                log(f"[tp-serve] {arch} fp32: {len(base['routing'])} router calls, both ranks' top_i the same bits; "
                    f"the one process routed by them; calls where its own top_i differed (call, tokens, largest "
                    f"probability gap of the token's largest; limit {TIE_RTOL}): {flips or 'none'}")
                assert all(gap <= TIE_RTOL for _, _, gap in flips), f"[tp-serve] {run}: not near-ties: {flips}"
            log(f"[tp-serve] {arch} fp32 kv_shard={kv_shard!r}, full width, {cfg.n_layers} layers, 2 gloo ranks "
                f"on one card (data 1 x model 2), prompts {prompts} into {S} rows, {TPS_STEPS} greedy steps: "
                f"tokens equal one process's on both ranks; logits within "
                f"{max(r[run]['logit_rel'] for r in ranks):.2e} of the row's largest (limit {TPS_LOGIT_RTOL}); "
                f"cache parts {ranks[0][run]['cache_shapes']}; launches a rank {ranks[0][run]['launches']}"
                + (f", decode at {dec_key}" if dec_key is not None else ", decode in torch ops"))
        else:
            bone = one[(arch, "bfloat16")]
            for r in ranks:
                got = r[run]
                got["agree"] = float((got["tokens"][:, 1:] == bone["tokens"][:, 1:]).mean())
                prof = got.get("profile")
                log(f"[tp-serve] {arch} bf16 kv_shard={kv_shard!r}, rank {r['rank']}: decode ms a step "
                    f"{np.median(got['step_ms']):.2f} (median of {TPS_STEPS}; {[round(x, 2) for x in got['step_ms']]}), "
                    f"{B} prefills + primes {got['prefill_ms']:.1f} ms"
                    + (f"; under the profiler {prof['profiled_wall_ms']:.2f} ms a step, device {prof['device_ms']:.2f} "
                       f"ms, busy {prof['busy']:.1%} (this rank's kernels)" if prof else "")
                    + f"; peak {got['peak'] / 2**30:.2f} GiB ({got['base'] / 2**30:.2f} GiB allocated before), "
                    f"argument bytes {got['arg_bytes']}; launches {got['launches']}; tokens equal to one process's bf16 "
                    f"run: {got['agree']:.3f} of {B * TPS_STEPS}")
                if prof:
                    log("[tp-serve] bf16 device time by kind: " + ", ".join(f"{k} {ms:.3f} ms" for k, ms in prof["kinds"]))
            log(f"[tp-serve] {arch}, one process on the card: bf16 decode ms a step "
                f"{np.median(bone['step_ms']):.2f}, fp32 {np.median(one[(arch, 'float32')]['step_ms']):.2f}")
    want_enc = _tps_encode(dev)
    scale = float(np.abs(want_enc).max())
    enc_err = [float(np.abs(r["encode"] - want_enc).max()) / scale for r in ranks]
    assert max(enc_err) <= TPS_ENCODE_RTOL, f"[tp-serve] hubert encode: {enc_err} of the largest logit"
    log(f"[tp-serve] hubert-xlarge encode, fp32, 2 layers, {TPS_ENCODE} frames on (data 1 x model 2): logits "
        f"{want_enc.shape} within {max(enc_err):.2e} of one process's largest (limit {TPS_ENCODE_RTOL})")
    n_coll = {"qkv all-gather": TPS_LAYERS, "(out, lse) all-gather": TPS_LAYERS,
              "activation sum": 2 * TPS_LAYERS + 1, "argmax all-gather": 1}  # deepseek-7b's bf16 "seq" step's calls
    for r in ranks:
        c = r["collective_ms"]
        log(f"[tp-serve] rank {r['rank']}: one gloo call on CUDA tensors, median of {TPS_COLL_ITERS}: "
            + ", ".join(f"{k} {v:.3f} ms (x{n_coll[k]} a step)" for k, v in c.items())
            + f"; {sum(c[k] * n for k, n in n_coll.items()):.2f} ms of collectives a decode step")
    names = [_tps_run_name(*run) for run in TPS_RUNS]
    launches = {k: sum(r[n]["launches"][k] for r in ranks for n in names) for k in ranks[0][names[0]]["launches"]}
    by_shape: dict = {}
    for r in ranks:
        for n in names:
            for kern, shapes in r[n]["by_shape"].items():
                for key, c in shapes.items():
                    by_shape.setdefault(kern, {})[key] = by_shape.setdefault(kern, {}).get(key, 0) + c
    seconds = time.perf_counter() - t_all
    log(f"[tp-serve] {seconds:.1f} s here; the ranks' runs {sum(r['seconds'] for r in ranks) / len(ranks):.1f} s "
        f"a rank, inside [tp]'s")
    bf16 = {arch: [r[_tps_run_name(arch, "bfloat16", "seq")] for r in ranks] for arch in TPS_ARCHS}
    b16 = bf16["deepseek-7b"]
    return dict(launches=launches, launches_by_shape=by_shape, seconds=seconds, agree=[r["agree"] for r in b16],
                collective_ms=[r["collective_ms"] for r in ranks],
                step_ms=[r["step_ms"] for r in b16], busy=[r["profile"]["busy"] for r in b16],
                peak=[r["peak"] for r in b16], base=[r["base"] for r in b16],
                arg_bytes=[r["arg_bytes"] for r in b16], step_temp=[r["step_temp"] for r in b16],
                arch={arch: dict(step_ms=[r["step_ms"] for r in rs], arg_bytes=[r["arg_bytes"] for r in rs],
                                 step_temp=[r["step_temp"] for r in rs], peak=[r["peak"] for r in rs],
                                 agree=[r["agree"] for r in rs])
                      for arch, rs in bf16.items()})


# [dryrun]: the train runs whose cells the dry run models on one device
DRYRUN_ARCHS = ("deepseek-7b", "qwen1.5-110b", "llama4-scout-17b-a16e")


def dryrun_phase(trains: dict, tp: dict, tp_serve: dict) -> dict:
    """20. The port's dry run (``launch/dryrun.py``: the step run on ``meta``
    tensors, on the CPU) of cells this script measures: ``[train]``'s
    deepseek-7b (its 30 layers, (2, 2048) in 2 microbatches, Adafactor,
    remat "full", logits chunks of 1024) on one device, the two new
    configs' ``[train-*]`` cells the same way, ``[tp]``'s bf16 cells
    (deepseek-7b, qwen3-moe) on a (data 1, model 2) mesh, and
    ``[tp-serve]``'s bf16 decode steps there (deepseek-7b, qwen3-moe,
    minicpm3-4b; their per-slot positions).  Its argument bytes (state, step, inputs;
    parameters, tokens, caches and positions) must equal the card's (each
    rank's); its peak is logged beside ``max_memory_allocated`` less what
    was allocated besides one step (earlier phases' leftovers, the other
    batches; for the decode step, the arguments plus the step's own rise),
    with the terms live at the predicted peak, and its FLOPs a step over
    the step's wall time."""
    from repro_torch.dist.sharding import DryRunMesh
    from repro_torch.launch.dryrun import model_cell
    from repro_torch.models import ShapeSpec

    t0 = time.perf_counter()
    train_shape = ShapeSpec("smoke_train", "train", TRAIN_SEQ, TRAIN_BATCH)
    cells = [(arch, trains[arch]["cfg"], train_shape, None, dict(n_microbatches=TRAIN_MB), [trains[arch]["arg_bytes"]],
              [trains[arch]["peak_bytes"] - trains[arch]["extra_bytes"]], trains[arch]["step_ms"])
             for arch in DRYRUN_ARCHS]
    for arch in TP_ARCHS:
        t = tp["arch"][arch]
        cells.append(("tp" if arch == "deepseek-7b" else f"tp {arch}", _tp_cfg("bfloat16", arch),
                      ShapeSpec("tp", "train", TP_SEQ, TP_BATCH), DryRunMesh({"data": 1, "model": 2}),
                      dict(n_microbatches=2), t["arg_bytes"], [p - b for p, b in zip(t["peak"], t["base"])],
                      float(np.median(t["step_ms"][0][1:]))))
    for arch in TPS_ARCHS:
        t = tp_serve["arch"][arch]
        cfg = _tps_cfg("bfloat16", arch=arch)
        cells.append(("tp-serve" if arch == "deepseek-7b" else f"tp-serve {arch}", cfg,
                      _tps_shape(cfg), DryRunMesh({"data": 1, "model": 2}), dict(pos_per_sequence=True), t["arg_bytes"],
                      [a + b for a, b in zip(t["arg_bytes"], t["step_temp"])], float(np.median(t["step_ms"][0]))))
    out = {}
    for name, cfg, shape, mesh, kw, measured_args, measured_peaks, step_ms in cells:
        t1 = time.perf_counter()
        rec = model_cell(cfg, shape, mesh, **kw)
        m, c = rec["memory"], rec["collectives"]
        where = "one device" if mesh is None else f"mesh {mesh.shape}, rank 0"
        log(f"[dryrun] {name} ({cfg.n_layers} layers, {where}): argument bytes {m['argument_size_in_bytes']} "
            f"predicted, {measured_args} on the card; peak {m['peak_bytes'] / 2**30:.3f} GiB predicted "
            f"(temp {m['temp_size_in_bytes'] / 2**30:.3f}), "
            + ", ".join(f"{p / 2**30:.3f} GiB ({p / m['peak_bytes'] - 1:+.1%})" for p in measured_peaks)
            + f" on the card; {rec['cost']['flops'] / 1e12:.2f} TFLOP a step ("
            f"{rec['cost']['flops'] / (step_ms / 1e3) / 1e12:.1f} TFLOP/s at {step_ms:.1f} ms a step); "
            f"collectives {c['total_count']} ({c['total_bytes']} bytes); {time.perf_counter() - t1:.1f} s")
        log(f"[dryrun] {name} live at the predicted peak: "
            + ", ".join(f"{term} {b / 2**30:.3f} GiB" for term, b in rec["peak_terms"][:6]))
        out[name] = dict(predicted=m, measured_args=measured_args, measured_peaks=measured_peaks,
                         flops=rec["cost"]["flops"], peak_terms=rec["peak_terms"])
    wrong = {k: (v["predicted"]["argument_size_in_bytes"], v["measured_args"]) for k, v in out.items()
             if any(a != v["predicted"]["argument_size_in_bytes"] for a in v["measured_args"])}
    assert not wrong, f"[dryrun] argument bytes predicted / measured: {wrong}"
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# 21. the wide routes: every shape the Pallas kernels take
# ---------------------------------------------------------------------------

# shape variants of two configs (dataclasses.replace; no file under configs/):
# deepseek-7b with 8 heads of 512 (d_model 4096 and the parameter count
# unchanged) and mamba2-130m with SSD head dim 128, state 256, chunk 512 (12
# heads; d_inner 1536 unchanged)
WIDE_DS = dict(n_heads=8, n_kv_heads=8, head_dim=512)
WIDE_M2 = dict(head_dim=128, d_state=256, chunk_size=512)
WIDE_DS_SERVE_LAYERS = 8  # of deepseek-7b's 30: the script's time limit (mamba2 serves all 24)
WIDE_TRAIN_LAYERS = {"deepseek-7b": 2, "mamba2-130m": 4}
WIDE_PROMPTS = {"deepseek-7b": (2048, 777, 100, 321), "mamba2-130m": (4096, 2048, 777, 100, 1000, 512, 64, 321)}
WIDE_GEN = 16
WIDE_SOURCES = {
    "flash_attention_wide": ("src/repro_torch/kernels/csrc/flash_attention_wide.cu",
                             "src/repro/kernels/flash_attention/kernel.py:111"),
    "flash_attention_bwd_wide": ("src/repro_torch/kernels/csrc/flash_attention_wide.cu",
                                 "src/repro/models/attention.py:139 (no Pallas kernel: JAX differentiates the "
                                 "jnp custom VJP)"),
    "decode_attention_wide": ("src/repro_torch/kernels/csrc/decode_attention_wide.cu",
                              "src/repro/kernels/decode_attention/kernel.py:81"),
    "ssd_wide": ("src/repro_torch/kernels/csrc/ssd_wide.cu", "src/repro/kernels/ssd/kernel.py:58"),
    "ssd_bwd_wide": ("src/repro_torch/kernels/csrc/ssd_wide.cu",
                     "src/repro/models/ssm.py:74 (no Pallas kernel: JAX differentiates the jnp ssd_chunked)"),
}


def _wide_cfg(arch: str):
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config(arch)
    if arch == "deepseek-7b":
        return full.replace(**WIDE_DS)
    return full.replace(ssm=dataclasses.replace(full.ssm, **WIDE_M2))


def _wide_kernel_checks(dev) -> None:
    """Each wide route against its plain version on the card, in fp32 and
    bf16, at head dims above 256 (Dh != Dv, GQA / MQA, windows, offset
    queries, ragged lengths), bf16 widths off the tensor-core grid, SSD P
    above 64, N above 128 and chunks above 256; each route's counter moves
    by one a call and the main routes' not at all, and a second run gives
    the same bits."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops

    gen = torch.Generator(device=dev).manual_seed(40)
    counts = {k: c for k, c in _kernel_ops().items() if not k.startswith("rmsnorm")}
    before = {k: c.count for k, c in counts.items()}
    n_calls = dict.fromkeys(counts, 0)
    flash_cases = [  # (B, Lq, Lk, H, KH, Dh, Dv, causal, window, q_offset)
        (1, 300, 300, 8, 8, 512, 512, True, None, 0), (2, 130, 200, 4, 2, 320, 288, True, 64, 70),
        (1, 65, 65, 2, 1, 300, 600, False, None, 0), (1, 333, 333, 8, 4, 100, 100, True, None, 0),
        (2, 77, 90, 4, 4, 36, 20, False, 30, 13)]
    for B, Lq, Lk, H, KH, Dh, Dv, causal, window, q_off in flash_cases:
        for dtype in (torch.bfloat16, torch.float32):
            if fops.route(Dh, Dv, dtype, Dh % 8 == 0 and Dv % 8 == 0) != "wide":
                continue
            q, k = _randn(gen, (B, Lq, H, Dh), dtype, dev), _randn(gen, (B, Lk, KH, Dh), dtype, dev)
            v, do = _randn(gen, (B, Lk, KH, Dv), dtype, dev), _randn(gen, (B, Lq, H, Dv), dtype, dev)
            kw = dict(causal=causal, window=window, q_offset=q_off)
            label = f"{dtype} B={B} Lq={Lq} Lk={Lk} H={H} KH={KH} Dh={Dh} Dv={Dv} {kw}"
            out, lse = fops.flash_attention(q, k, v, return_lse=True, **kw)
            want, want_lse = fops.attention_fwd_ref(q, k, v, **kw)
            _compare(f"wide flash {label}", out, want, dtype)
            _compare(f"wide flash lse {label}", lse, want_lse, None, dict(atol=1e-4, rtol=0))
            got = fops.flash_attention_bwd(q, k, v, want, want_lse, do, **kw)
            for name, g, w in zip(("dq", "dk", "dv"), got, fops.attention_bwd_ref(q, k, v, want, want_lse, do, **kw)):
                _compare_bwd(f"wide flash bwd {name} {label}", g, w, dtype)
            assert torch.equal(out, fops.flash_attention(q, k, v, **kw)), f"wide flash {label}: not deterministic"
            again = fops.flash_attention_bwd(q, k, v, want, want_lse, do, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), f"wide flash bwd {label}: not deterministic"
            n_calls["flash_attention_wide"] += 2
            n_calls["flash_attention_bwd_wide"] += 2
    for B, S, H, KH, Dh, Dv, pos_l in ((4, 2304, 8, 8, 512, 512, [2063, 792, 115, 336]),
                                       (3, 300, 8, 2, 320, 288, [0, 150, 299])):
        for dtype in (torch.bfloat16, torch.float32):
            q, k = _randn(gen, (B, 1, H, Dh), dtype, dev), _randn(gen, (B, S, KH, Dh), dtype, dev)
            v = _randn(gen, (B, S, KH, Dv), dtype, dev)
            pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
            label = f"{dtype} B={B} S={S} H={H} KH={KH} Dh={Dh} Dv={Dv} pos {pos_l}"
            out = dops.decode_attention(q, k, v, pos)
            _compare(f"wide decode {label}", out, dops.decode_attention_ref(q, k, v, pos), dtype)
            assert torch.equal(out, dops.decode_attention(q, k, v, pos)), f"wide decode {label}: not deterministic"
            half = S // 2  # the partial route on the cache's two halves, combined
            parts = [dops.decode_attention(q, k[:, s0:s0 + half], v[:, s0:s0 + half], pos, slot_offset=s0,
                                           partial=True) for s0 in (0, half)]
            for (o, lse), s0 in zip(parts, (0, half)):
                wo, wl = dops.decode_attention_ref(q, k[:, s0:s0 + half], v[:, s0:s0 + half], pos, s0, True)
                _compare(f"wide decode partial slot {s0} {label}", o, wo, dtype)
                live = torch.isfinite(wl)
                assert torch.equal(live, torch.isfinite(lse))
                _compare(f"wide decode partial lse slot {s0} {label}", lse[live], wl[live], None,
                         dict(atol=LSE_ATOL, rtol=0))
            both = dops.combine_partials(torch.stack([o for o, _ in parts]), torch.stack([l for _, l in parts]))
            _compare(f"wide decode partial combined {label}", both.to(dtype), out, dtype)
            n_calls["decode_attention_wide"] += 4
    for b, L, cs, H, G, P, N in ((1, 1024, 512, 12, 1, 128, 256), (2, 96, 48, 4, 2, 96, 160),
                                 (1, 640, 320, 4, 4, 16, 16), (1, 80, 40, 4, 1, 20, 12)):
        for dtype in (torch.bfloat16, torch.float32):
            if sops.route(cs, P, N, dtype, P % 8 == 0 and N % 8 == 0) != "wide":
                continue
            for shift in (-1.0, 3.0):  # a strong decay: exp of the masked triangle overflows
                args, dy, dS = _ssd_bwd_args(gen, dev, dtype, b, L, H, G, cs, shift, P=P, N=N)
                label = f"{dtype} b={b} L={L} cs={cs} H={H} G={G} P={P} N={N} dt_shift={shift}"
                got = sops.ssd_intra_chunk(*args)
                for name, g, w in zip(("y", "state"), got, sops.ssd_chunk_ref(*args)):
                    _compare_ssd(f"wide ssd {name} {label}", g, w)
                grads = sops.ssd_intra_chunk_bwd(*args, dy, dS)
                for name, g, w in zip(("dx", "ddt", "dcum", "dB", "dC"), grads,
                                      sops.ssd_chunk_bwd_ref(*args, dy, dS)):
                    _compare_bwd(f"wide ssd bwd {name} {label}", g, w, dtype)
                assert all(torch.equal(a, c) for a, c in zip(got, sops.ssd_intra_chunk(*args))), label
                assert all(torch.equal(a, c) for a, c in zip(grads, sops.ssd_intra_chunk_bwd(*args, dy, dS))), label
                n_calls["ssd_wide"] += 2
                n_calls["ssd_bwd_wide"] += 2
    torch.cuda.synchronize()
    moved = {k: c.count - before[k] for k, c in counts.items()}
    want = n_calls
    log(f"[wide] kernel checks: every wide route within tolerance of its plain version in fp32 and bf16, run to "
        f"run identical; launches {moved}")
    assert moved == want, (moved, want)


def _ssd_wide_times(gen, dev, b, L, H, P, N, cs, backward: bool) -> dict:
    """Kernel and plain times of the wide ssd route (bf16) at (b, L, H, P)
    / (b, L, 1, N), chunk cs, and the bound of the work: the forward's
    scores, y and state, or the backward's ``bwd_flops``, at the bf16
    rate, against each input read once and each output written once."""
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import ssd_chunk_bwd_ref, ssd_chunk_ref

    dtype, G, nc = torch.bfloat16, 1, L // cs
    sets = [_ssd_bwd_args(gen, dev, dtype, b, L, H, G, cs, P=P, N=N) for _ in range(2)]
    if backward:
        sets = [(*args, dy, dS) for args, dy, dS in sets]
        fn, ref, flops = ops.ssd_intra_chunk_bwd, ssd_chunk_bwd_ref, ops.bwd_flops(b, H, nc, cs, P, N)
        got, want = fn(*sets[0]), ref(*sets[0])
        err = max(_compare_bwd(f"wide ssd bwd {n} at the path's shape", g, w, dtype)
                  for n, g, w in zip(("dx", "ddt", "dcum", "dB", "dC"), got, want))
        # x, B, C, dx, dB, dC in bf16; dt, cum, dy, dS read, ddt, dcum written in f32
        bytes_moved = (2 * b * L * H * P + 4 * b * L * G * N) * 2 + (4 * b * L * H + b * L * H * P
                                                                     + b * H * nc * N * P) * 4
    else:
        sets = [args for args, _, _ in sets]
        fn, ref, flops = ops.ssd_intra_chunk, ssd_chunk_ref, ops.fwd_flops(b, H, nc, cs, P, N)
        got, want = fn(*sets[0]), ref(*sets[0])
        err = max(_compare_ssd(f"wide ssd {n} at the path's shape", g, w) for n, g, w in zip(("y", "state"), got, want))
        # x, B, C in bf16; dt, cum read, y and the state written in f32
        bytes_moved = (b * L * H * P + 2 * b * L * G * N) * 2 + (2 * b * L * H + b * L * H * P + b * H * nc * N * P) * 4
    del got, want
    ms = time_ms(fn, sets)
    plain = time_ms(ref, sets[:1], iters=3)
    bound, by = _bound(bytes_moved, flops, dtype)
    what = "bwd" if backward else "fwd"
    log(f"[wide] ssd {what} at x ({b}, {L}, {H}, {P}), B/C ({b}, {L}, {G}, {N}) bf16, cs {cs}: {flops / 1e9:.2f} "
        f"GFLOP, kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms, bound {bound:.4f} ms "
        f"({by}, {bound / ms:.1%} of it)")
    return dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound, bound_by=by, max_abs_err=err,
                shape=f"x ({b}, {L}, {H}, {P}), B/C ({b}, {L}, {G}, {N}) bf16, cs {cs}; {flops / 1e9:.2f} GFLOP")


def _wide_attention_errs(gen, dev, H: int, D: int, L: int, pos_l: list) -> dict:
    """The attention wide routes against their plain versions at the path's
    shapes (bf16): the forward and backward at (1, L, H, D) causal, decode
    against a (4, MAX_SEQ, H, D) cache at ``pos_l``; each the largest
    absolute error over its outputs."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops

    dtype = torch.bfloat16
    q, k, v, do = (_randn(gen, (1, L, H, D), dtype, dev) for _ in range(4))
    want, lse = fops.attention_fwd_ref(q, k, v)
    errs = {"flash_attention_wide": _compare("wide flash at the path's shape", fops.flash_attention(q, k, v),
                                             want, dtype)}
    errs["flash_attention_bwd_wide"] = max(
        _compare_bwd(f"wide flash bwd {n} at the path's shape", g, w, dtype)
        for n, g, w in zip(("dq", "dk", "dv"), fops.flash_attention_bwd(q, k, v, want, lse, do),
                           fops.attention_bwd_ref(q, k, v, want, lse, do)))
    B = len(pos_l)
    q, k, v = _randn(gen, (B, 1, H, D), dtype, dev), _randn(gen, (B, MAX_SEQ, H, D), dtype, dev), \
        _randn(gen, (B, MAX_SEQ, H, D), dtype, dev)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    errs["decode_attention_wide"] = _compare("wide decode at the path's shape", dops.decode_attention(q, k, v, pos),
                                             dops.decode_attention_ref(q, k, v, pos), dtype)
    return errs


def _wide_records(dev) -> list[dict]:
    """Each wide route timed at its path's shape (deepseek-7b's heads of 512
    and mamba2-130m's wide SSD, bf16): kernel, plain and library times (SDPA
    where it takes the shape), the bound of the work and the largest error
    against the plain version there."""
    gen = torch.Generator(device=dev).manual_seed(41)
    H, D, L = WIDE_DS["n_heads"], WIDE_DS["head_dim"], TRAIN_SEQ
    m2 = _wide_cfg("mamba2-130m")
    mH, mP, mN, mcs = m2.ssm.expand * m2.d_model // m2.ssm.head_dim, m2.ssm.head_dim, m2.ssm.d_state, m2.ssm.chunk_size
    pos_l = [2063, 792, 115, 336]
    errs = _wide_attention_errs(gen, dev, H, D, L, pos_l)
    times = {"flash_attention_wide": _flash_times(gen, dev, 1, L, H, D),
             "flash_attention_bwd_wide": _flash_bwd_times(gen, dev, 1, L, H, D),
             "decode_attention_wide": _decode_times(gen, dev, H, D, pos_l),
             "ssd_wide": _ssd_wide_times(gen, dev, 1, 4096, mH, mP, mN, mcs, backward=False),
             "ssd_bwd_wide": _ssd_wide_times(gen, dev, M2_BATCH // M2_MB, M2_SEQ, mH, mP, mN, mcs, backward=True)}
    records = []
    for name, t in times.items():
        source, replaces = WIDE_SOURCES[name]
        t.setdefault("max_abs_err", errs.get(name))
        records.append(dict(name=name, route="cuda", source=source, replaces=replaces, **t))
    return records


def _wide_serve(dev, arch: str) -> dict:
    """The wide variant of ``arch`` through ``ServeEngine`` at full width
    (deepseek-7b cut to ``WIDE_DS_SERVE_LAYERS``): the prompts of
    ``WIDE_PROMPTS`` greedy, ``WIDE_GEN`` tokens each; exact launch counts
    on the wide routes and none on the main routes' attention / ssd; one
    greedy stream against the sequential prefill + decode loop."""
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = _wide_cfg(arch)
    if arch == "deepseek-7b":
        cfg, n_slots, max_seq = cfg.replace(n_layers=WIDE_DS_SERVE_LAYERS), N_SLOTS, MAX_SEQ
    else:
        n_slots, max_seq = M_SLOTS, M_MAX_SEQ
    tag = f"[wide] {arch}"
    t0 = time.perf_counter()
    model = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{tag} serving: {cfg.n_layers} layers, {n_params / 1e9:.3f} B params, "
        + (f"{cfg.n_heads} heads of {cfg.head_dim}" if cfg.ssm is None else
           f"SSD head dim {cfg.ssm.head_dim}, state {cfg.ssm.d_state}, chunk {cfg.ssm.chunk_size}")
        + f", bf16, initialised in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in WIDE_PROMPTS[arch]]
    ops = _kernel_ops()
    with ServeEngine(cfg, model, n_slots=n_slots, max_seq=max_seq, block_size=BLOCK_SIZE, device=dev) as eng:
        # ---- the main path: counts from 0 just before, read just after ----
        for c in ops.values():
            c.reset()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, WIDE_GEN) for p in prompts]
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: c.count for name, c in ops.items()}
        # --------------------------------------------------------------------
        prefills, decode_steps = eng.prefills, eng.decode_steps
    assert all(r.done and len(r.out_tokens) == WIDE_GEN for r in reqs), "a request did not finish"
    want = _serve_launches(cfg, prefills=prefills, decode_steps=decode_steps)
    log(f"{tag} {len(reqs)} requests, {sum(len(r.out_tokens) for r in reqs)} tokens in {wall:.3f} s; "
        f"{prefills} prefills, {decode_steps} decode steps; launches {launches}, expected {want}")
    assert launches == want, "the wide variant did not run through the wide routes as expected"
    assert launches["ssd_wide" if cfg.ssm else "flash_attention_wide"] > 0
    want_toks = _sequential_greedy(model, cfg, prompts[1], 1, dev, n_slots=n_slots, max_seq=max_seq, gen=WIDE_GEN)[0]
    assert reqs[1].out_tokens == want_toks, (reqs[1].out_tokens, want_toks)
    log(f"{tag} the stream of prompt {len(prompts[1])} equals the sequential loop's: {want_toks[:8]}...")
    del model
    return dict(launches=launches, wall_s=wall)


def _wide_train(dev, arch: str) -> dict:
    """One bf16 train step of the wide variant at full width and
    ``WIDE_TRAIN_LAYERS`` (deepseek-7b: Adafactor, (2, 2048) in 2
    microbatches; mamba2-130m: AdamW, (8, 2048) in 2): finite loss and
    grad norm, exact launch counts on the wide routes (flash / ssd forward
    and backward)."""
    from repro_torch.runtime.train import build_train_step, init_train_state

    gc.collect()
    torch.cuda.empty_cache()
    cfg = _wide_cfg(arch).replace(n_layers=WIDE_TRAIN_LAYERS[arch])
    if arch == "deepseek-7b":
        cfg, batch, seq, n_mb = cfg.replace(optimizer="adafactor"), TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB
    else:
        batch, seq, n_mb = M2_BATCH, M2_SEQ, M2_MB
    state = init_train_state(cfg, 0, device=dev)
    art = build_train_step(cfg, n_microbatches=n_mb)
    b = _batches(cfg, dev, 1, batch, seq)[0]
    ops = _kernel_ops()
    torch.cuda.synchronize()
    # ---- the main path: counts from 0 just before, read just after ----
    for c in ops.values():
        c.reset()
    t0 = time.perf_counter()
    state, m = art(state, b)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = {name: c.count for name, c in ops.items()}
    # ------------------------------------------------------------------
    want = _train_launches_per_step(cfg, n_mb)
    loss, gn = float(m["loss"]), float(m["grad_norm"])
    log(f"[wide] {arch} train step ({cfg.n_layers} layers, bf16, {cfg.optimizer}, ({batch}, {seq}) in {n_mb} "
        f"microbatches): loss {loss:.5f}, grad norm {gn:.5f}, {wall:.1f} ms (the first step: builds included); "
        f"launches {launches}, expected {want}")
    assert np.isfinite(loss) and np.isfinite(gn), (loss, gn)
    assert launches == want, "the wide train step did not run through the wide routes as expected"
    del state, art
    return dict(launches=launches, step_ms=wall, loss=loss)


def wide_phase(dev) -> dict:
    """``[wide]``: the wide routes (``csrc/*_wide.cu``) at every shape the
    main routes refuse.  Each against its plain version in fp32 and bf16,
    run to run identical (``_wide_kernel_checks``); then two shape variants
    of repo configs at full width, through the normal entry points:
    deepseek-7b with 8 heads of 512 (serving through ``ServeEngine`` cut to
    8 layers, one bf16 train step at 2 layers, and a 1-layer fp32 check of
    prefill / decode logits and of a train step, card against the CPU
    port) and mamba2-130m with SSD head dim 128, state 256, chunk 512
    (serving 8 slots with prompts up to 4096, one train step at 4 layers,
    the same fp32 checks); exact launch counts on the wide routes in every
    run; each route timed at its path's shape."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    _wide_kernel_checks(dev)
    records = _wide_records(dev)
    runs = []
    for arch in ("deepseek-7b", "mamba2-130m"):
        runs.append(_wide_serve(dev, arch))
        runs.append(_wide_train(dev, arch))
        f32 = _wide_cfg(arch).replace(n_layers=1, dtype="float32")
        counts = _kernel_ops()
        before = {n: c.count for n, c in counts.items()}
        model_phase(dev, f32, prompt_len=1100 if f32.ssm else 128)
        moved = {n: c.count - before[n] for n, c in counts.items()}
        assert moved["ssd_wide" if f32.ssm else "flash_attention_wide"] == 1, moved
        assert f32.ssm or moved["decode_attention_wide"] == 4, moved
        chunk = 128 if f32.ssm is None else None
        with _host_memory_kept():  # Adafactor, as [train-parity]'s deepseek-7b (AdamW's CPU side is slower)
            runs.append(_parity_run(dev, f32.replace(logits_chunk=chunk or f32.logits_chunk, optimizer="adafactor"),
                                    tag="wide", seq=128 if f32.ssm is None else 1024, steps=1))
    for r in records:
        r["launches"] = sum(run["launches"][r["name"]] for run in runs)
        assert r["launches"] > 0, f"{r['name']}: no launch on the wide variants' paths"
    log(f"[wide] launches on the wide variants' paths: {({r['name']: r['launches'] for r in records})}; "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(records=records, runs=runs)


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
    wide = phase("wide", wide_phase, dev)
    phase("f2", f2_digests)
    phase("codelets", codelet_phase, dev)
    examples = phase("examples", examples_phase, dev)
    serve = phase("serve", serving_phase, dev)
    serve_m = phase("mamba2", recurrent_serving_phase, dev)
    serve_g = phase("serve-gemma", serving_phase, dev, "gemma-7b", "serve-gemma")
    serve_c = phase("serve-minicpm3", serving_phase, dev, "minicpm3-4b", "serve-minicpm3",
                    n_layers=MINICPM3_SERVE_LAYERS)
    serve_r = phase("serve-rgemma", recurrent_serving_phase, dev, "recurrentgemma-9b", "serve-rgemma")
    serve_q = phase("serve-moe", serving_phase, dev, "qwen3-moe-235b-a22b", "serve-moe", n_layers=MOE_SERVE_LAYERS)
    serve_h = phase("serve-hubert", encoder_serving_phase, dev)
    serve_v = phase("serve-internvl", vision_serving_phase, dev)
    serve_q110 = phase("serve-qwen110b", serving_phase, dev, "qwen1.5-110b", "serve-qwen110b",
                       n_layers=NEW_SERVE_LAYERS)
    serve_l4 = phase("serve-llama4", serving_phase, dev, "llama4-scout-17b-a16e", "serve-llama4",
                     n_layers=NEW_SERVE_LAYERS)
    from repro_torch.configs import get_config

    model_errs = {}
    for arch, n_layers, prompt_len in (("deepseek-7b", 2, 256), ("mamba2-130m", 4, 600), ("gemma-7b", 2, 256),
                                       ("minicpm3-4b", 2, 256), ("recurrentgemma-9b", 3, 256),
                                       ("qwen3-moe-235b-a22b", 1, 256), ("qwen1.5-110b", 1, 128),
                                       ("llama4-scout-17b-a16e", 1, 128)):
        cfg = get_config(arch).replace(n_layers=n_layers, dtype="float32")
        model_errs[arch] = phase(f"model {arch}", model_phase, dev, cfg, prompt_len=prompt_len)
    parity = phase("train-parity", train_parity_phase, dev)
    trains = {arch: phase(TRAIN_RUNS[arch][1], train_phase, dev, arch) for arch in TRAIN_RUNS}
    train, train_g = trains["deepseek-7b"], trains["gemma-7b"]
    train_m2 = phase("train-m2", train_m2_phase, dev)
    remat = phase("remat", remat_phase, dev)
    cfg, model = _deepseek(dev, "spec")
    spec = phase("spec", spec_phase, dev, cfg, model)
    load = phase("load", load_phase, dev, cfg, model)
    del model
    ckpt = phase("ckpt", ckpt_phase, dev)
    comm = phase("comm", comm_phase, dev)
    pipe = phase("pipeline", pipeline_phase, dev)
    chaos = phase("chaos", chaos_phase, dev)
    mesh = phase("mesh", mesh_phase, dev)
    tp = phase("tp", tp_phase, dev)
    tp_serve = phase("tp-serve", tp_serve_phase, dev, tp)
    dry = phase("dryrun", dryrun_phase, trains, tp, tp_serve)
    # launches on every path: serving and train (every model), speculation, load, checkpoint, the launcher,
    # the pipeline, the chaos soak's serve runs, the mesh's train steps, the tensor-parallel ranks' steps,
    # their serving runs and the wide variants' paths (fp32 runs count on the wide routes)
    records += wide["records"]
    runs = (serve, serve_m, serve_g, serve_c, serve_r, serve_q, serve_h, serve_v, serve_q110, serve_l4,
            *trains.values(), train_m2, remat,
            spec, load, ckpt, comm, pipe, chaos, mesh, tp, tp_serve, *wide["runs"])
    for r in records:
        r["launches"] = sum(run["launches"][r["name"]] for run in runs)
    _frontend_shape_launches(records, {"hubert": (serve_h, trains["hubert-xlarge"]),
                                       "internvl": (serve_v, trains["internvl2-2b"]), "tp": (tp, tp_serve),
                                       "tpserve": (tp_serve,),
                                       "qwen110b": (serve_q110, trains["qwen1.5-110b"]),
                                       "llama4": (serve_l4, trains["llama4-scout-17b-a16e"])})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    shape_keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [dict({k: r[k] for k in keys}, shape=r["shape"],
                    other_shapes={n: {k: t.get(k) for k in shape_keys + (("launches",) if "launches" in t else ())}
                                  for n, t in _sub_shapes(r).items()})
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
        f"{serve_q['tok_per_s']:.1f} tok/s, qwen1.5-110b / llama4-scout ({NEW_SERVE_LAYERS} layers) serving "
        f"{serve_q110['tok_per_s']:.1f} / {serve_l4['tok_per_s']:.1f} tok/s, dry run "
        f"{dry['seconds']:.1f} s, mamba2 train step {train_m2['step_ms']:.1f} ms "
        f"({train_m2['tokens_per_s']:.1f} tokens/s), examples {examples['seconds']:.1f} s, "
        f"self-draft accept rate {spec['self draft']['accept_rate']:.3f}, "
        f"load checksum {load['continuous']['output_checksum']}, checkpoint {ckpt['bytes']} bytes, "
        f"comm phase {comm['seconds']:.1f} s, pipeline {PIPE_LAYERS} layers 1f1b / fifo "
        f"{pipe['bf16']['1f1b']['wall_ms']:.1f} / {pipe['bf16']['fifo']['wall_ms']:.1f} ms (bubble "
        f"{pipe['bf16']['1f1b']['bubble']:.3f} / {pipe['bf16']['fifo']['bubble']:.3f}), chaos {chaos['seconds']:.1f} s, "
        f"mesh {mesh['seconds']:.1f} s, tp (2 ranks, model 2) bf16 step ms {tp['step_ms']} (fp32 worst weight "
        f"{tp['fp32_worst']:.2e} of its max; qwen3-moe {tp['moe_step_ms']}), tp-serve bf16 decode ms a step "
        f"(qwen3-moe {[round(float(np.median(m)), 2) for m in tp_serve['arch'][TP_MOE]['step_ms']]}, minicpm3-4b "
        f"{[round(float(np.median(m)), 2) for m in tp_serve['arch'][TPS_MLA]['step_ms']]}) deepseek-7b "
        f"{[round(float(np.median(m)), 2) for m in tp_serve['step_ms']]} (busy "
        f"{[round(b, 3) for b in tp_serve['busy']]}, tokens agreeing with one process {tp_serve['agree']}), hubert-xlarge encoder {serve_h['wall_ms']:.1f} ms a 2 x 4096 call "
        f"({serve_h['frames_per_s']:.1f} frames/s, peak {serve_h['peak_bytes'] / 2**30:.2f} GiB, fp32 "
        f"{serve_h['fp32_err']:.2e}), internvl2-2b prefill {serve_v['prefill_ms']:.1f} ms and decode "
        f"{serve_v['decode_ms']:.2f} ms a step (peak {serve_v['peak_bytes'] / 2**30:.2f} GiB, fp32 "
        f"{serve_v['fp32_err']:.2e}), remat dots_saveable / full {remat['dots_ms']:.1f} / {remat['full_ms']:.1f} ms "
        f"(peak {remat['dots_peak'] / 2**30:.2f} / {remat['full_peak'] / 2**30:.2f} GiB, bit for bit), wide routes "
        + ", ".join(f"{r['name']} {r['ms']:.4f} ms ({r['launches']} launches)" for r in wide["records"])
        + f", {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
