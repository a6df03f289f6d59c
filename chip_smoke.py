"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. header   — card name and power limit (nvidia-smi), torch and CUDA versions;
2. build    — builds the hand-written kernels from ``src/repro_torch/kernels/csrc``;
3. kernels  — each kernel against its plain PyTorch version on the card, at
              the serving path's deepseek-7b shapes (bf16) and at edge shapes
              (fp32 and bf16), with kernel / plain / library times and bounds;
4. serving  — full-width deepseek-7b (30 layers, bf16, seeded random init)
              through ``repro_torch.serving.ServeEngine``: ragged prompts and a
              sampled request, then duplicates that take the prefix-share and
              the restore paths; launch counts show the path ran through all
              three kernels; one greedy request is held against a sequential
              prefill + decode loop;
5. model    — full width cut to 2 layers in fp32: the card's logits against
              the CPU port's (plain versions) for a prompt and decode steps.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Needs one card; imports nothing of JAX.
"""
from __future__ import annotations

import json
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
        if "registers" in line or "bytes stack" in line or line.startswith("=="):
            log(f"[build] {line.strip()}")
    return dt


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def _randn(gen, shape, dtype, dev, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def _compare(name, got, want, dtype) -> float:
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output not finite")
    err = (got - want).abs()
    tol = TOL[dtype]
    bad = err > tol["atol"] + tol["rtol"] * want.abs()
    max_err = float(err.max())
    log(f"[kernels] {name}: max_abs_err {max_err:.3e} (limit atol {tol['atol']} + rtol {tol['rtol']}·|plain|)")
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
    for dtype in (torch.bfloat16, torch.float32):
        for T, D in ((1, 4096), (100, 4096), (2048, 4096), (37, 128), (5, 16)):
            x = _randn(gen, (T, D), dtype, dev)
            s = _randn(gen, (D,), dtype, dev, 0.1)
            e = _compare(f"rmsnorm {dtype} T={T} D={D}", ops.rmsnorm(x, s), rmsnorm_ref(x, s), dtype)
            if dtype == torch.bfloat16 and (T, D) == (2048, 4096):
                err = e
    # main-path shape: prefill rows of deepseek-7b
    T, D, dtype = 2048, 4096, torch.bfloat16
    sets = [(_randn(gen, (T, D), dtype, dev), _randn(gen, (D,), dtype, dev, 0.1)) for _ in range(4)]
    ms = time_ms(ops.rmsnorm, sets)
    plain = time_ms(rmsnorm_ref, sets)
    weights = [(x, (1.0 + s.float()).to(dtype)) for x, s in sets]
    lib = time_ms(lambda x, w: torch.nn.functional.rms_norm(x, (D,), w, 1e-6), weights)
    bound, by = _bound(2 * T * D * 2 + D * 2, 4 * T * D, dtype)
    return dict(
        name="rmsnorm", route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm/kernel.py:27", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib,
        shape=f"x ({T}, {D}) bf16",
    )


def _pairs(Lq, Lk, causal, window, q_offset) -> int:
    """(query, key) pairs the mask keeps: the work this input needs."""
    qpos = torch.arange(Lq, dtype=torch.int64) + q_offset
    hi = torch.clamp(qpos + 1, max=Lk) if causal else torch.full_like(qpos, Lk)
    lo = torch.clamp(qpos - window + 1, min=0) if window else torch.zeros_like(qpos)
    return int(torch.clamp(hi - lo, min=0).sum())


def check_flash(dev) -> dict:
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [  # (B, Lq, Lk, H, KH, D, causal, window, q_offset, dtypes)
        (1, 2048, 2048, 32, 32, 128, True, None, 0, (torch.bfloat16,)),
        (2, 1000, 1000, 32, 8, 128, True, 256, 0, (torch.bfloat16, torch.float32)),
        (1, 300, 1000, 8, 2, 64, True, None, 700, (torch.bfloat16, torch.float32)),
        (1, 333, 333, 4, 4, 128, False, None, 0, (torch.float32,)),
        (2, 77, 77, 4, 1, 32, True, 40, 0, (torch.float32,)),
    ]
    err = 0.0
    for B, Lq, Lk, H, KH, D, causal, window, q_off, dtypes in cases:
        for dtype in dtypes:
            q = _randn(gen, (B, Lq, H, D), dtype, dev)
            k = _randn(gen, (B, Lk, KH, D), dtype, dev)
            v = _randn(gen, (B, Lk, KH, D), dtype, dev)
            kw = dict(causal=causal, window=window, q_offset=q_off)
            e = _compare(
                f"flash {dtype} B={B} Lq={Lq} Lk={Lk} H={H} KH={KH} D={D} {kw}",
                ops.flash_attention(q, k, v, **kw), attention_ref(q, k, v, **kw), dtype,
            )
            if Lq == 2048:
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
    B, S, H, D, dtype = N_SLOTS, MAX_SEQ, 32, 128, torch.bfloat16
    pos = torch.tensor(main_pos, dtype=torch.int32, device=dev)
    sets = [
        (_randn(gen, (B, 1, H, D), dtype, dev), _randn(gen, (B, S, H, D), dtype, dev),
         _randn(gen, (B, S, H, D), dtype, dev), pos)
        for _ in range(2)
    ]
    ms = time_ms(ops.decode_attention, sets)
    plain = time_ms(decode_attention_ref, sets)
    valid = (torch.arange(S, device=dev)[None, :] <= pos[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = time_ms(
        lambda q, k, v, p: sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=valid),
        sets,
    )
    n_valid = sum(min(p + 1, S) for p in main_pos)
    bytes_moved = (2 * B * H * D + 2 * n_valid * H * D) * 2 + B * 4
    bound, by = _bound(bytes_moved, 4 * n_valid * H * D, dtype)
    return dict(
        name="decode_attention", route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:81", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib,
        shape=f"q ({B}, 1, {H}, {D}), cache ({B}, {S}, {H}, {D}) bf16, pos {main_pos}",
    )


def kernel_phase(dev) -> list[dict]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records = [check_rmsnorm(dev), check_flash(dev), check_decode(dev)]
    for r in records:
        log(
            f"[kernels] {r['name']} at {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
        )
    return records


# ---------------------------------------------------------------------------
# 4. serving at full width
# ---------------------------------------------------------------------------

def _kernel_ops() -> dict:
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops

    return {"rmsnorm": rmsnorm_ops, "flash_attention": flash_ops, "decode_attention": decode_ops}


def _sequential_greedy(model, cfg, prompt, slot, dev) -> list[int]:
    """Oracle (``tests/test_serving.py``'s): prefill, then a greedy
    ``decode_step`` loop.  The sequence sits in ``slot`` of a batch as wide
    as the engine's, so every matrix product has the engine's shape."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.runtime.serve import prime_cache

    logits, caches = prefill(model, {"tokens": torch.from_numpy(prompt[None, :]).to(dev)}, cfg)
    primed = prime_cache(cfg, caches, len(prompt), MAX_SEQ)
    full = init_cache(cfg, N_SLOTS, MAX_SEQ, device=dev)
    for k in full:
        full[k][:, slot] = primed[k][:, 0]
    del primed, caches
    toks = [int(torch.argmax(logits[0, -1]))]
    tok_in = torch.zeros((N_SLOTS, 1), dtype=torch.int32, device=dev)
    pos = torch.zeros(N_SLOTS, dtype=torch.int32, device=dev)
    for s in range(GEN - 1):
        tok_in[slot, 0] = toks[-1]
        pos[slot] = len(prompt) + s
        logits, full = decode_step(model, tok_in, full, pos, cfg)
        toks.append(int(torch.argmax(logits[slot, 0])))
    return toks


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
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0.0)
        if t and ev.device_type.name == "CUDA":
            rows.append((ev.key[:90], t / 1e3 / n_iter))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(ms for _, ms in rows)
    return dict(wall_ms=wall_ms, profiled_wall_ms=prof_wall_ms, device_ms=device_ms,
                busy=device_ms / prof_wall_ms if prof_wall_ms else 0.0, top=rows[:12])


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

    reqs = greedy + [sampled, dup, dup_restore]
    assert all(r.done and len(r.out_tokens) == GEN for r in reqs), "a request did not finish"
    assert stats["restores"] == 1 and stats["prefills"] == 5, f"admission paths: {stats}"
    assert stats["pool"]["shared_hits"] >= 1, f"no prefix sharing: {stats}"
    n_fwd = stats["prefills"] + stats["decode_steps"]
    want = {
        "flash_attention": cfg.n_layers * stats["prefills"],
        "decode_attention": cfg.n_layers * stats["decode_steps"],
        "rmsnorm": (2 * cfg.n_layers + 1) * n_fwd,
    }
    log(f"[serve] launches on the main path {launches}; expected {want} from "
        f"{stats['prefills']} prefills and {stats['decode_steps']} decode steps")
    assert launches == want, "the main path did not run through every kernel as expected"
    assert all(v > 0 for v in launches.values())

    n_tok = sum(len(r.out_tokens) for r in reqs)
    log(f"[serve] {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tok/s, "
        f"first token included), {stats['steps']} engine iterations, {stats['prefills']} prefills, "
        f"{stats['restores']} restores, peak device memory {peak / 2**30:.2f} GiB")
    for r in reqs:
        log(f"[serve]   prompt {len(r.prompt):5d} temp {r.temperature}: TTFT "
            f"{(r.t_first - r.t_arrival) * 1e3:.1f} ms, tokens {r.out_tokens[:8]}...")
    log(f"[serve] duplicate (prefix-shared, re-prefilled) stream equals the original's: "
        f"{dup.out_tokens == greedy[0].out_tokens}; restored request's first tokens {dup_restore.out_tokens[:8]}")

    want_toks = _sequential_greedy(model, cfg, prompts[1], 1, dev)
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
    return dict(
        launches=launches, tok_per_s=n_tok / wall, wall_s=wall, peak_bytes=peak, stats=stats,
        ttft_ms=[(r.t_first - r.t_arrival) * 1e3 for r in reqs], decode_profile=sp,
    )


# ---------------------------------------------------------------------------
# 5. whole model: card against CPU
# ---------------------------------------------------------------------------

def model_phase(dev, cfg=None, limit: float = 1e-3) -> float:
    """Full width, depth cut to 2 layers, float32: logits of a 256-token
    prefill and 4 decode steps on the card (kernels) against the CPU port
    (plain versions).  The limit allows for sums taken in other orders on
    the two devices (TF32 off); a wrong kernel is off by O(1)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer, decode_step, init_params, prefill
    from repro_torch.runtime.serve import prime_cache

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfg or get_config("deepseek-7b").replace(n_layers=2, dtype="float32")
    gpu = init_params(cfg, 1, device=dev)
    cpu = Transformer(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, 256)).astype(np.int32))
    worst = 0.0

    def rel(a, b) -> float:
        a, b = a.float().cpu(), b.float()
        assert torch.isfinite(a).all()
        return float((a - b).abs().max() / b.abs().max())

    lg, cg = prefill(gpu, {"tokens": prompt.to(dev)}, cfg)
    lc, cc = prefill(cpu, {"tokens": prompt}, cfg)
    worst = max(worst, rel(lg, lc))
    cg, cc = prime_cache(cfg, cg, 256, 264), prime_cache(cfg, cc, 256, 264)
    tok = torch.argmax(lc[:, 0], dim=-1).to(torch.int32)[:, None]
    for s in range(4):
        lg, cg = decode_step(gpu, tok.to(dev), cg, 256 + s, cfg)
        lc, cc = decode_step(cpu, tok, cc, 256 + s, cfg)
        worst = max(worst, rel(lg, lc))
        tok = torch.argmax(lc[:, 0], dim=-1).to(torch.int32)[:, None]
    log(f"[model] 2-layer full-width fp32, card vs CPU: max relative logit error {worst:.3e} (limit {limit})")
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
    serve = serving_phase(dev)
    model_err = model_phase(dev)
    for r in records:
        r["launches"] = serve["launches"][r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    kernels = [{k: r[k] for k in keys} for r in records]
    log(f"[done] {smi}: build {build_s:.1f} s, model check {model_err:.2e}, "
        f"{time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
