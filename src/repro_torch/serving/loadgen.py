"""Load generator for the serving tier.  A port of ``repro.serving.loadgen``:
the same seeded workload and the same output checksum.

Builds a seeded, reproducible open-loop workload — Poisson arrivals
(exponential inter-arrival gaps), mixed prompt/output lengths drawn from
small fixed sets (bounding the number of distinct matrix shapes), and an
optional duplicated-prompt fraction that exercises the paged pool's prefix
sharing — then drives a :class:`~repro_torch.serving.engine.ServeEngine`
through it in one of two modes:

* ``"continuous"`` — requests are submitted the moment they arrive; the
  engine admits them mid-flight (continuous batching).
* ``"drain"`` — the generation-wide-barrier baseline (static batching):
  when the engine is idle, up to ``n_slots`` arrived requests form a
  generation, and that batch runs to completion before the next batch is
  admitted.

Both modes run the *same* workload through the *same* engine build, so the
metric deltas (tokens/s, p50/p99 time-to-first-token, p50/p99 inter-token
latency) isolate the scheduling policy.  TTFT is measured from the
request's *arrival* time, not its submit time — in drain mode the queueing
delay before submission is precisely the cost being measured.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.scheduler import AdmissionError


@dataclass(frozen=True)
class LoadSpec:
    """Reproducible workload description (everything derives from ``seed``)."""

    seed: int = 0
    n_requests: int = 24
    rate_rps: float = 40.0
    prompt_lens: tuple = (5, 9, 13, 17)
    out_lens: tuple = (4, 8, 12)
    vocab: int = 64
    dup_frac: float = 0.25  # fraction of requests reusing an earlier prompt
    temperature: float = 0.0
    top_k: int = 0
    #: submit requests with speculative decoding (requires an engine built
    #: with a draft model); committed output is bit-identical either way,
    #: so spec-vs-plain runs of the same workload isolate the speedup
    speculative: bool = False


@dataclass
class Arrival:
    at: float  # seconds after workload start
    prompt: np.ndarray
    max_new_tokens: int


def build_workload(spec: LoadSpec) -> list[Arrival]:
    """Materialize the arrival schedule.  Same spec → same workload."""
    rng = np.random.default_rng(spec.seed)
    arrivals: list[Arrival] = []
    t = 0.0
    for i in range(spec.n_requests):
        t += float(rng.exponential(1.0 / spec.rate_rps))
        if arrivals and rng.random() < spec.dup_frac:
            prompt = arrivals[int(rng.integers(len(arrivals)))].prompt
        else:
            L = int(rng.choice(spec.prompt_lens))
            prompt = rng.integers(0, spec.vocab, size=L).astype(np.int32)
        out = int(rng.choice(spec.out_lens))
        arrivals.append(Arrival(t, prompt, out))
    return arrivals


def _percentiles_ms(xs: list[float]) -> dict:
    if not xs:
        return {"p50": 0.0, "p99": 0.0}
    a = np.asarray(xs) * 1e3
    return {"p50": float(np.percentile(a, 50)), "p99": float(np.percentile(a, 99))}


def warm_up(engine: ServeEngine, spec: LoadSpec) -> None:
    """Run each prompt length the workload will hit (one prefill shape per
    length + the decode step) once, so first-use costs (worker threads, each
    matrix shape's cuBLAS set-up) stay out of the measured window.  Warmup
    prompts use token ``spec.vocab + 1``, outside the workload's range, so
    they cannot donate prefix hits to the measured run.

    ``repro`` feeds that token even when it lies past the model's vocabulary,
    where JAX clamps the gather; a CUDA embedding asserts on the device
    instead, so here it must be a real token id: ``ValueError`` otherwise."""
    if spec.vocab + 1 >= engine.cfg.vocab:
        raise ValueError(
            f"warm-up token {spec.vocab + 1} (LoadSpec.vocab + 1) is not below the "
            f"model's vocabulary of {engine.cfg.vocab}"
        )
    for L in spec.prompt_lens:
        prompt = np.full(L, spec.vocab + 1, np.int32)
        engine.submit(prompt, 2, temperature=spec.temperature,
                      top_k=spec.top_k, seed=0, speculative=spec.speculative)
    engine.run_until_drained()
    # repeat one prompt so the restore (prefix-hit) path is warm too
    engine.submit(np.full(spec.prompt_lens[0], spec.vocab + 1, np.int32), 2,
                  temperature=spec.temperature, top_k=spec.top_k, seed=0,
                  speculative=spec.speculative)
    engine.run_until_drained()


def run_load(
    engine: ServeEngine,
    workload: list[Arrival],
    *,
    mode: str = "continuous",
    spec: Optional[LoadSpec] = None,
    warmup: bool = True,
) -> dict:
    """Drive ``engine`` through ``workload`` and return latency metrics."""
    if mode not in ("continuous", "drain"):
        raise ValueError(f"unknown load mode {mode!r}")
    if warmup and spec is not None:
        warm_up(engine, spec)

    sampling = dict(
        temperature=spec.temperature if spec else 0.0,
        top_k=spec.top_k if spec else 0,
        speculative=spec.speculative if spec else None,
    )
    t0 = time.perf_counter()
    upcoming = list(workload)
    live: list = []
    rejected = 0
    while upcoming or engine.scheduler.queue_depth or engine.n_running:
        now = time.perf_counter() - t0
        # drain mode only feeds the engine when it is completely idle, and
        # at most one slot-sized generation at a time — the static-batching
        # barrier the continuous scheduler removes
        gate = (
            len(workload)
            if mode == "continuous"
            else (
                engine.n_slots
                if engine.n_running == 0 and engine.scheduler.queue_depth == 0
                else 0
            )
        )
        while upcoming and upcoming[0].at <= now and gate > 0:
            gate -= 1
            arr = upcoming.pop(0)
            try:
                req = engine.submit(
                    arr.prompt, arr.max_new_tokens,
                    seed=len(live), **sampling,
                )
            except AdmissionError:
                rejected += 1
                continue
            req.t_arrival = t0 + arr.at  # charge queueing from *arrival*
            live.append(req)
        if engine.n_running or engine.scheduler.queue_depth:
            engine.step()
        elif upcoming:
            time.sleep(max(0.0, upcoming[0].at - (time.perf_counter() - t0)))
    elapsed = time.perf_counter() - t0

    done = [r for r in live if r.done and not r.rejected]
    ttfts = [r.t_first - r.t_arrival for r in done if r.t_first is not None]
    itls = [
        b - a for r in done for a, b in zip(r.t_tokens, r.t_tokens[1:])
    ]
    n_tokens = sum(len(r.out_tokens) for r in done)
    ttft = _percentiles_ms(ttfts)
    itl = _percentiles_ms(itls)
    # order-independent fingerprint of committed output: two runs of the
    # same workload (e.g. speculative vs plain greedy decode) must match
    digest = hashlib.sha256(
        repr(sorted(
            (tuple(int(t) for t in r.prompt), tuple(r.out_tokens))
            for r in done
        )).encode()
    ).hexdigest()[:16]
    return {
        "output_checksum": digest,
        "mode": mode,
        "requests": len(done),
        "rejected": rejected,
        "tokens": n_tokens,
        "elapsed_s": elapsed,
        "tokens_per_s": n_tokens / elapsed if elapsed > 0 else 0.0,
        "ttft_p50_ms": ttft["p50"],
        "ttft_p99_ms": ttft["p99"],
        "itl_p50_ms": itl["p50"],
        "itl_p99_ms": itl["p99"],
        "engine": engine.stats(),
    }
