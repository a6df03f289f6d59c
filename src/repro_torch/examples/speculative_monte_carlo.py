"""Monte-Carlo speculation example — the paper's §3.2 / [Bramas'19] use case.

A Metropolis-style chain: each step proposes a move (maybe-accepted →
``SpMaybeWrite`` on the state) followed by an expensive observable
evaluation reading the state.  With speculation (``SP_MODEL_1``) the
evaluation runs ahead assuming rejection and is rolled back only on
acceptance; without it (``SP_NO_SPEC``) it waits.  The chain is driven by
numpy from a seed, so a seed gives ``examples/speculative_monte_carlo.py``'s
exact values.  The state and the observable are float64 tensors on the card
(``--device cpu``: on the host)::

    PYTHONPATH=src python -m repro_torch.examples.speculative_monte_carlo [--device cpu]

``main(argv)`` returns one row per acceptance probability.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (
    SpComputeEngine,
    SpData,
    SpMaybeWrite,
    SpRead,
    SpSpeculativeModel,
    SpTaskGraph,
    SpWorkerTeamBuilder,
    SpWrite,
)
from repro_torch.kernels.dispatch import resolve_device


def run(spec: bool, accept_p: float, steps: int = 24, d: float = 5e-3, seed: int = 7,
        device="cuda"):
    """One chain → (wall s, state, obs, speculation stats).  ``device``
    defaults to the card, as every entry point does, and raises without a
    Hopper card; pass ``"cpu"`` to run on the host."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    proposals = rng.normal(size=steps)
    accepts = rng.random(steps) < accept_p
    model = SpSpeculativeModel.SP_MODEL_1 if spec else SpSpeculativeModel.SP_NO_SPEC
    eng = SpComputeEngine(SpWorkerTeamBuilder.team_of_cpu_workers(4))
    try:
        tg = SpTaskGraph(model).compute_on(eng)
        state = SpData(torch.zeros((), dtype=torch.float64, device=device), "state")
        obs = SpData(torch.zeros((), dtype=torch.float64, device=device), "obs")
        t0 = time.perf_counter()
        for i in range(steps):
            def propose(ref, i=i):
                time.sleep(d)  # energy computation of the proposal
                if accepts[i]:
                    ref.value = ref.value + float(proposals[i])

            def observe(sv, oref):
                time.sleep(d)  # expensive observable
                oref.value = oref.value + sv

            tg.task(SpMaybeWrite(state), propose, name=f"propose{i}")
            tg.task(SpRead(state), SpWrite(obs), observe, name=f"observe{i}")
        tg.wait_all_tasks()
        wall = time.perf_counter() - t0
        return wall, float(state.value), float(obs.value), dict(tg.spec_stats)
    finally:
        eng.stop()


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--accept-p", type=float, nargs="+", default=[0.0, 0.2, 0.5, 0.8])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = []
    print("accept_p  no-spec   spec    speedup  commits/rollbacks")
    for p in args.accept_p:
        w0, s0, o0, _ = run(False, p, args.steps, seed=args.seed, device=dev)
        w1, s1, o1, st = run(True, p, args.steps, seed=args.seed, device=dev)
        assert (s0, o0) == (s1, o1), "speculation must not change results"
        print(
            f"  {p:.1f}    {w0 * 1e3:6.0f}ms {w1 * 1e3:6.0f}ms  {w0 / w1:5.2f}x"
            f"   {st['commits']}/{st['rollbacks']}"
        )
        rows.append({"accept_p": p, "state": s1, "obs": o1, "no_spec_ms": w0 * 1e3,
                     "spec_ms": w1 * 1e3, "commits": st["commits"], "rollbacks": st["rollbacks"]})
    print("(speedup is largest when rejections dominate — the paper's regime)")
    return rows


if __name__ == "__main__":
    main()
