"""Chaos soak harness: seeded fault schedules over the three recovery
surfaces, with exact (or explicitly bounded) correctness checks — the port
of ``repro.dist.chaos``.

Each scenario builds its whole world from one integer ``seed`` — the
fault schedule (drop/duplicate/delay/truncate draws, flaky bursts, the
kill step and victim), the workload, and the oracle — so a failing soak
is replayed bit-for-bit by rerunning the same seed.  Payloads are torch
tensors on ``device`` (the card unless ``device="cpu"``), and every group
receives onto it:

* :func:`chaos_collectives` — ring all-reduce over a :class:`ChannelHub`
  wrapped in :class:`~repro_torch.dist.fault.FaultyTransport` (drops,
  dupes, delays, truncations) under a
  :class:`~repro_torch.dist.fault.RetryingTransport` budget.  Inputs are
  integer-valued float32 (< 2**24), so float addition is exact and the
  reduction is order-independent: every iteration must be **bit-exact**
  against the sum, faults or not.

* :func:`chaos_collectives_p2p` — the same bit-exactness soak over the
  *real* p2p data plane: one ``SocketTransport`` per rank, frames over
  direct TCP peer links, each rank's injector scoped with ``peers=`` to its
  ring neighbor's stream — drops/dupes/delays/truncations land on the
  direct links themselves.

* :func:`chaos_elastic` — the in-process elastic-training story: thread
  ranks drive ``SpRuntime(elastic=True).elastic_loop``; at a seeded step
  a seeded victim rank dies mid-collective (its death is published via
  ``mark_dead``, standing in for the router's detector).  Survivors must
  recover *in-runtime* — no failure handling in the step function — and
  every step's result must be bit-exact against the full-mesh oracle
  before the resume step and the survivors-only oracle from it on.

* :func:`chaos_serve` — the serve engine under admission chaos: seeded
  bursts of requests with mixed deadlines (some already expired), seeded
  mid-decode ``cancel()`` calls, and a pool sized to force preemptions, on
  ``reduced_config("deepseek-7b")`` with weights from a seeded torch
  generator (on the card its flash, decode and rmsnorm kernels run).  The
  checks are invariants rather than bit-exactness (cancellation is a
  scheduling race by design): every request terminates, every rejection
  carries a valid ``reject_reason``, completed requests have exactly the
  tokens they asked for, and the drained engine holds no slots, queue
  entries, or pinned block tables.

``python -m repro_torch.dist.chaos --seeds 3 --iters 20`` runs all
scenarios for seeds ``0..2`` on the card; ``--device cpu`` runs them on the
CPU.
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.core import ChannelHub, SpCommGroup, SpData, SpRuntime
from repro_torch.dist.collectives import ring_all_reduce
from repro_torch.dist.fault import FaultyTransport, RetryingTransport
from repro_torch.kernels.dispatch import resolve_device


def _int_grad(rank: int, step: int, n: int, device) -> torch.Tensor:
    """Integer-valued float32 input: sums stay < 2**24, so float32 addition
    is exact and associative — the oracle is bit-exact regardless of ring
    order, retries, or recovery replays."""
    return ((torch.arange(n, dtype=torch.float32, device=device) % 17.0)
            + float((rank + 1) * (step + 2)))


def _oracle(ranks, step: int, n: int, device) -> torch.Tensor:
    return sum(_int_grad(r, step, n, device) for r in ranks)


def _check(got, want, what: str) -> None:
    if got is None:
        raise AssertionError(f"{what} lost")
    if got.device != want.device or not torch.equal(got, want):
        raise AssertionError(f"{what}: not bit for bit the sum (on {got.device}, want {want.device})")


def _run_ranks(worker, size: int, join_s: float) -> None:
    """One thread a rank; re-raise the first rank's error."""
    errors: list[BaseException] = []

    def run(rank: int) -> None:
        try:
            worker(rank)
        except BaseException as e:  # surfaced to the caller, not swallowed
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=join_s)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"a rank did not finish within {join_s} s")


def _soak(transports, size: int, iters: int, n: int, timeout: float, device, label: str,
          join_s=None) -> None:
    """Every rank ring-all-reduces ``iters`` integer-valued payloads over its
    transport; each result must be bit for bit the sum, on ``device``."""
    results: dict = {}

    def worker(rank: int) -> None:
        group = SpCommGroup(rank, size, transports[rank], default_timeout=timeout, device=device)
        with SpRuntime(workers=2) as rt:
            for it in range(iters):
                x = SpData(_int_grad(rank, it, n, device), f"{label}{rank}.{it}")
                ring_all_reduce(rt.graph, group, x, op="sum", tag=it)
                rt.wait_all_tasks(timeout=timeout)
                results[(rank, it)] = x.value

    _run_ranks(worker, size, join_s if join_s is not None else iters * timeout)
    for it in range(iters):
        ref = _oracle(range(size), it, n, device)
        for rank in range(size):
            _check(results.get((rank, it)), ref, f"rank {rank} iteration {it}")


# ---------------------------------------------------------------------------
# Scenario 1: collectives under link faults (no deaths — absorption).
# ---------------------------------------------------------------------------

def chaos_collectives(
    seed: int,
    iters: int = 20,
    *,
    size: int = 3,
    n: int = 96,
    timeout: float = 60.0,
    device="cuda",
) -> dict:
    """Soak ring all-reduce over a lossy, delaying, duplicating link layer;
    every iteration must reduce bit-exactly."""
    device = resolve_device(device)
    hub = ChannelHub()
    faulty = FaultyTransport(
        hub, seed=seed, drop=0.04, duplicate=0.04, delay=0.04,
        delay_s=0.002, truncate=0.03,
    )
    transport = RetryingTransport(faulty, max_retries=6, backoff=0.001)
    _soak([transport] * size, size, iters, n, timeout, device, "cc")
    transport.close()
    stats = {"iters": iters, "size": size, "faults": dict(faulty.injected),
             "retries": transport.retries, "escalations": transport.escalations}
    assert stats["escalations"] == 0, stats  # absorbed, never escalated
    return stats


# ---------------------------------------------------------------------------
# Scenario 1b: collectives under link faults on the real p2p data plane.
# ---------------------------------------------------------------------------

def chaos_collectives_p2p(
    seed: int,
    iters: int = 20,
    *,
    size: int = 3,
    n: int = 96,
    timeout: float = 60.0,
    join_timeout=None,
    device="cuda",
) -> dict:
    """Soak ring all-reduce over *direct TCP peer links*: one
    :class:`~repro_torch.core.SocketTransport` per rank (in-process
    threads, real sockets), each wrapped in a :class:`FaultyTransport`
    whose injection is scoped via ``peers=`` to that rank's ring neighbor
    — the stream the collective actually uses — under a
    :class:`RetryingTransport` budget.  Every iteration must reduce
    bit-exactly; no fault may escalate to a death.  ``join_timeout`` bounds
    the wait for the ranks (default ``iters * timeout``)."""
    from repro_torch.core import SocketTransport

    device = resolve_device(device)
    base = [SocketTransport(0, size, port=0)]
    for r in range(1, size):
        base.append(SocketTransport(r, size, port=base[0].port))
    faulties, transports = [], []
    for r in range(size):
        f = FaultyTransport(
            base[r], seed=seed * size + r, drop=0.04, duplicate=0.04,
            delay=0.04, delay_s=0.002, truncate=0.03,
            peers=[(r + 1) % size],
        )
        faulties.append(f)
        transports.append(RetryingTransport(f, max_retries=6, backoff=0.001))
    try:
        _soak(transports, size, iters, n, timeout, device, "cp", join_timeout)
        stats = {
            "iters": iters, "size": size,
            "faults": {k: sum(f.injected[k] for f in faulties)
                       for k in faulties[0].injected},
            "retries": sum(t.retries for t in transports),
            "escalations": sum(t.escalations for t in transports),
            "links": sum(b.stats().get("links", 0) for b in base),
        }
    finally:
        # rank 0 last: its rendezvous otherwise waits for the peers
        for tr in reversed(transports):
            tr.close()
    assert stats["escalations"] == 0, stats  # absorbed, never escalated
    assert stats["links"] >= size, stats  # frames really took direct links
    assert stats["faults"]["dropped"] + stats["faults"]["duplicated"] > 0, (
        "the seeded schedule never exercised the direct links"
    )
    return stats


# ---------------------------------------------------------------------------
# Scenario 2: elastic training surviving a seeded mid-collective death.
# ---------------------------------------------------------------------------

def chaos_elastic(
    seed: int,
    iters: int = 20,
    *,
    size: int = 3,
    n: int = 64,
    timeout: float = 30.0,
    device="cuda",
) -> dict:
    """Thread ranks all-reduce for ``iters`` steps; a seeded victim dies at
    a seeded step.  Survivors' per-step results must match the full-mesh
    oracle before the resume step and the survivors-only oracle after."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    kill_at = int(rng.integers(1, max(2, iters - 1)))
    victim = int(rng.integers(1, size))
    hub = ChannelHub()
    faulty = FaultyTransport(
        hub, seed=seed, drop=0.02, duplicate=0.02,
        flaky={(victim + 1) % size: 2},
    )
    transport = RetryingTransport(faulty, max_retries=6, backoff=0.001)
    out: dict[int, tuple[dict, list]] = {}

    def worker(rank: int) -> None:
        group = SpCommGroup(rank, size, transport, default_timeout=timeout, device=device)
        try:
            with SpRuntime(workers=2, elastic=True, group=group,
                           detect_grace=timeout) as rt:
                def step_fn(step):
                    if rank == victim and step == kill_at:
                        # die mid-collective; mark_dead stands in for the
                        # socket router's failure detector (in-process hubs
                        # have no kernel to close a dead peer's socket)
                        hub.mark_dead(rank)
                        raise SystemExit
                    x = SpData(_int_grad(rank, step, n, device),
                               f"ce{rank}.e{rt.epoch}.s{step}")
                    ring_all_reduce(rt.graph, rt.group, x, op="sum",
                                    tag=(rt.epoch, step))
                    rt.barrier(timeout=timeout)
                    return x.value

                res = rt.elastic_loop(step_fn, iters, step_timeout=timeout)
                out[rank] = (res, rt.recoveries)
        except SystemExit:
            pass

    _run_ranks(worker, size, iters * timeout)
    survivors = [r for r in range(size) if r != victim]
    assert set(out) == set(survivors), (sorted(out), survivors)
    for rank in survivors:
        res, recs = out[rank]
        assert sorted(res) == list(range(iters)), sorted(res)
        assert len(recs) == 1 and recs[0]["dead"] == [victim], recs
        resume = recs[0]["resume"]
        for step, got in res.items():
            ranks = range(size) if step < resume else survivors
            _check(got, _oracle(ranks, step, n, device), f"rank {rank} step {step}")
    transport.close()
    rec = out[survivors[0]][1][0]
    return {"iters": iters, "kill_at": kill_at, "victim": victim,
            "resume": rec["resume"], "recovery_s": rec["seconds"],
            "faults": dict(faulty.injected)}


# ---------------------------------------------------------------------------
# Scenario 3: serve engine under admission chaos.
# ---------------------------------------------------------------------------

def chaos_serve(seed: int, iters: int = 20, *, max_steps: int = 4000, device="cuda") -> dict:
    """Seeded request bursts with expired deadlines, mid-decode cancels and
    a preemption-prone pool; asserts termination + accounting invariants."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine

    device = resolve_device(device)
    cfg = reduced_config("deepseek-7b")
    params = init_params(cfg, 0, device=device)
    rng = np.random.default_rng(seed)
    all_reqs: list = []
    cancelled: list = []
    with ServeEngine(cfg, params, n_slots=2, max_seq=48, block_size=4,
                     n_blocks=20, max_queue=8, overload="shed-oldest", device=device) as eng:
        total_steps = 0
        for it in range(iters):
            burst = []
            for _ in range(int(rng.integers(2, 5))):
                prompt = rng.integers(0, cfg.vocab,
                                      int(rng.integers(4, 10))).astype(np.int32)
                gen = int(rng.integers(3, 9))
                # ~1/4 of requests arrive already past their deadline
                deadline = 0.0 if rng.random() < 0.25 else None
                burst.append(eng.submit(prompt, gen, deadline=deadline))
            all_reqs.extend(burst)
            # seeded mid-flight cancel of one live request in ~1/3 of bursts
            if rng.random() < 0.33:
                live = [r for r in burst if r.deadline is None]
                if live:
                    vic = live[int(rng.integers(len(live)))]
                    eng.step()
                    vic.cancel()
                    cancelled.append(vic)
            while eng.scheduler.queue_depth or eng.n_running:
                eng.step()
                total_steps += 1
                assert total_steps < max_steps, "serve soak failed to drain"
        stats = eng.stats()
        # invariants: everything terminated, rejections are typed, nothing
        # leaked — a violated one means a request or its KV blocks wedged
        assert all(r.done for r in all_reqs)
        for r in all_reqs:
            if r.rejected:
                assert r.reject_reason in ("queue_full", "shed", "deadline"), r
            elif not r.cancelled:
                assert len(r.out_tokens) == r.max_new_tokens, r
        assert eng.n_running == 0 and eng.scheduler.queue_depth == 0
        assert not eng.pool._tables, "leaked pinned block tables"
    return {"iters": iters, "requests": len(all_reqs),
            "completed": sum(1 for r in all_reqs
                             if r.done and not r.rejected and not r.cancelled),
            "deadline_shed": stats["deadline_shed"], "shed": stats["shed"],
            "cancels": stats["cancels"], "cancelled_q": stats["cancelled"],
            "preemptions": stats["preemptions"], "steps": stats["steps"],
            "prefills": stats["prefills"], "decode_steps": stats["decode_steps"]}


SCENARIOS = {
    "collectives": chaos_collectives,
    "collectives_p2p": chaos_collectives_p2p,
    "elastic": chaos_elastic,
    "serve": chaos_serve,
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3,
                    help="run seeds 0..N-1 through every scenario")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--scenario", choices=(*SCENARIOS, "all"), default="all")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    names = list(SCENARIOS) if args.scenario == "all" else [args.scenario]
    report: dict = {}
    for name in names:
        for seed in range(args.seeds):
            t0 = time.perf_counter()
            stats = SCENARIOS[name](seed, args.iters, device=args.device)
            dt = time.perf_counter() - t0
            report[f"{name}/seed{seed}"] = stats
            print(f"[chaos] {name} seed={seed} iters={args.iters} device={args.device} "
                  f"ok in {dt:.1f}s: {stats}")
    print(f"[chaos] {len(report)} soak runs passed "
          f"({args.seeds} seeds x {args.iters} iterations each)")
    return report


if __name__ == "__main__":
    main()
