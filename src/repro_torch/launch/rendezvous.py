"""Multi-process rank bootstrap for the socket transport (paper §4.4): the
port's copy of ``repro.launch.rendezvous``, with payloads that live on a
device.

One OS process per rank, each with a
:class:`~repro_torch.core.comm.SocketTransport` dialed into a shared
localhost rendezvous (rank 0 binds the port and runs the *address
exchange*; every rank registers its own data listener there, then frames
flow over lazily dialed direct peer links), drives the same non-blocking
comm-task protocol the in-process :class:`~repro_torch.core.comm.ChannelHub`
exercises — ``ring_all_reduce`` built from ``mpi_send`` / ``mpi_recv``
tasks, progressed by each process's comm thread.

Demo / measurement entry point::

    PYTHONPATH=src python -m repro_torch.launch.rendezvous --size 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.rendezvous --size 4 --n 128921472

spawns the ranks with :mod:`multiprocessing` (the ``spawn`` context: a
forked child of a parent that has touched CUDA cannot use the card),
reduces a float32 vector over TCP, checks every rank's sum bit for bit
against a NumPy replay of the ring's own addition order, and prints each
rank's wall time and bus bandwidth.

Devices: every ``run_*`` function takes ``device=`` (default ``"cuda"``; ``"cuda"``
without a Hopper card raises "no CUDA card").  Each rank process puts its
payloads on that device and receives onto it (``SpCommGroup(device=)``);
on the card it initializes CUDA *before* bootstrapping its transport, so
a slow first CUDA call cannot read as a dead rank under the elastic
runs' 3 s heartbeat window.  Reports come back as NumPy arrays, or,
with ``digest=True`` (large payloads), as :func:`payload_digest` strings of their
bytes, each beside the device the result lived on.

Elastic recovery: when a rank dies mid-run the survivors must *agree* on
the dead set before resharding.  :func:`reroll_ranks` is that agreement: a
fixed two-round, epoch-tagged all-to-all over the raw transport (view
exchange → union confirmation), returning the shrunken
:class:`~repro_torch.core.SpCommGroup` plus every survivor's piggy-backed
payload.  :func:`run_elastic_ring` / :func:`run_elastic_train` spawn real
OS ranks, SIGKILL one mid-``ring_all_reduce``, and return the survivors'
results plus detection / recovery timings.
"""
from __future__ import annotations

import functools
import hashlib
import multiprocessing as mp
import os
import queue as _queue
import signal
import time
from typing import Any, Optional

import numpy as np

__all__ = [
    "bootstrap_transport",
    "payload_digest",
    "elastic_train_oracle",
    "reroll_ranks",
    "ring_order_sum",
    "run_collective",
    "run_elastic_ring",
    "run_elastic_train",
    "run_ring_reduce",
]


def bootstrap_transport(
    rank: int,
    size: int,
    *,
    port: int,
    host: str = "127.0.0.1",
    timeout: float = 30.0,
    max_dial_retries: int = 100,
    heartbeat_interval: float | None = None,
    heartbeat_timeout: float | None = None,
    transport: str = "p2p",
):
    """Create this rank's transport: rank 0 binds ``port`` as the
    rendezvous, everyone dials.  ``transport`` selects the wire
    implementation — ``"p2p"`` (the direct-dial data plane,
    :class:`SocketTransport`) or ``"router"`` (the legacy star
    :class:`RouterTransport`, kept as a measured baseline).  The dial
    loop is bounded: at most ``max_dial_retries`` attempts with
    exponential backoff inside ``timeout`` seconds, then a ``SpCommError``
    naming the rendezvous address."""
    from repro_torch.core.comm import RouterTransport, SocketTransport

    try:
        cls = {"p2p": SocketTransport, "router": RouterTransport}[transport]
    except KeyError:
        raise ValueError(
            f"unknown transport {transport!r}; use 'p2p' or 'router'"
        ) from None
    return cls(
        rank,
        size,
        host=host,
        port=port,
        connect_timeout=timeout,
        max_dial_retries=max_dial_retries,
        heartbeat_interval=heartbeat_interval,
        heartbeat_timeout=heartbeat_timeout,
    )


def reroll_ranks(
    group,
    *,
    epoch: int,
    payload: Any = None,
    timeout: float = 30.0,
    poll_interval: float = 0.002,
):
    """Epoch-tagged rendezvous re-roll: survivors agree on the dead set and
    exchange payloads, then the group shrinks to the survivors.

    Fixed two-round protocol over the raw transport (no comm tasks — the
    task graph that just failed may still hold in-flight requests):

    1. every presumed survivor broadcasts its local view
       ``{dead, payload}`` to the others and collects theirs; a peer whose
       poll raises ``SpRankDeadError`` mid-round joins the dead set;
    2. every survivor broadcasts the *union* dead set it computed and
       checks the unions agree — divergence (a death landing between the
       rounds) raises ``SpCommError``, and the caller re-rolls with a
       fresh ``epoch``.

    Exactly two rounds on every rank, so no rank stalls waiting for a
    round its peers never run.  Returns ``(shrunk_group, dead, payloads)``
    with ``payloads`` keyed by surviving physical rank (self included).
    """
    from repro_torch.core.comm import SpCommError, SpRankDeadError

    tr = group.hub
    me = group.rank

    def _exchange(round_no: int, msg: Any, peers: list[int]) -> tuple[dict, set]:
        """Send ``msg`` to ``peers``, collect their round-``round_no``
        messages; returns (views, found_dead)."""
        newly_dead: set[int] = set()
        tag = ("__reroll__", epoch, round_no)
        for r in peers:
            try:
                tr.post((me, r, tag), msg)
            except SpRankDeadError:
                newly_dead.add(r)
        views: dict[int, Any] = {me: msg}
        pending = set(peers) - newly_dead
        deadline = time.monotonic() + timeout
        while pending:
            for r in list(pending):
                try:
                    ok, m = tr.poll((r, me, tag))
                except SpRankDeadError:
                    newly_dead.add(r)
                    pending.discard(r)
                    continue
                if ok:
                    views[r] = m
                    pending.discard(r)
            if not pending:
                break
            if time.monotonic() > deadline:
                raise SpCommError(
                    f"reroll epoch {epoch} round {round_no}: ranks "
                    f"{sorted(pending)} never answered within {timeout}s"
                )
            time.sleep(poll_interval)
        return views, newly_dead

    dead = set(tr.dead_ranks)
    alive = [r for r in group.members if r not in dead and r != me]

    views, newly = _exchange(1, {"dead": sorted(dead), "payload": payload}, alive)
    dead |= newly
    for v in views.values():
        dead |= set(v["dead"])
    dead |= set(tr.dead_ranks)  # deaths detected while round 1 ran

    survivors = [r for r in alive if r not in dead]
    unions, newly2 = _exchange(2, sorted(dead), survivors)
    dead |= newly2
    for r, their_union in unions.items():
        if r != me and set(their_union) != dead - newly2:
            raise SpCommError(
                f"reroll epoch {epoch}: dead-set divergence — rank {r} "
                f"sees {their_union}, this rank sees {sorted(dead)}; "
                f"re-roll with a fresh epoch"
            )

    payloads = {
        r: v["payload"] for r, v in views.items() if r == me or r not in dead
    }
    return group.shrunk(sorted(dead)), frozenset(dead), payloads


# ---------------------------------------------------------------------------
# Rank-process plumbing shared by the run_* functions.
# ---------------------------------------------------------------------------

def _check_device(device) -> None:
    """Raise in the parent, before anything is spawned, when ``device`` is
    ``cuda`` and no Hopper card is present."""
    from repro_torch.kernels.dispatch import resolve_device

    resolve_device(device)


def _rank_device(device):
    """This rank's device.  On the card CUDA is initialized here, before
    the transport starts its heartbeats: a first CUDA call that takes
    seconds must not look like a dead rank to the peers."""
    import torch

    from repro_torch.kernels.dispatch import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
    return dev


def payload_digest(a) -> str:
    """BLAKE2b of an array's (or tensor's, or list of them) bytes, with
    dtype and shape: how a rank reports a payload too large for the result
    queue, and how its oracle is compared."""
    import torch

    h = hashlib.blake2b(digest_size=20)
    for part in a if isinstance(a, (list, tuple)) else [a]:
        if isinstance(part, torch.Tensor):
            part = part.detach().cpu().numpy()
        part = np.ascontiguousarray(part)
        h.update(f"{part.dtype.str}{part.shape}".encode())
        h.update(memoryview(part).cast("B"))
    return h.hexdigest()


def _report(value, use_digest: bool):
    """What a rank sends back for ``value`` (a tensor or a list of them):
    NumPy copies, or their :func:`payload_digest`."""
    if use_digest:
        return payload_digest(value)
    if isinstance(value, list):
        return [v.detach().cpu().numpy() for v in value]
    return value.detach().cpu().numpy()


def _device_of(value) -> str:
    return str((value[0] if isinstance(value, list) else value).device)


def _spawn_ranks(target, size: int, args_of):
    """Start every rank at once: ``args_of(rank, port_q)`` gives each
    rank's argument tuple.  Rank 0 binds an OS-assigned rendezvous port
    and hands it to the others through ``port_q`` (:func:`_join`), so no
    port is picked by the parent and then lost to a race, and the ranks'
    start-up (imports, CUDA) overlaps.  Returns the processes and the
    queue, which the caller keeps alive until the ranks are reaped."""
    ctx = mp.get_context("spawn")
    port_q: Any = ctx.Queue()
    procs = [ctx.Process(target=target, args=args_of(r, port_q), daemon=True)
             for r in range(size)]
    for p in procs:
        p.start()
    return procs, port_q


def _join(rank: int, size: int, port_q, timeout: float = 120.0, **kw):
    """This rank's transport (:func:`bootstrap_transport`): rank 0 binds
    the rendezvous and posts its port once for every other rank."""
    if rank == 0:
        tr = bootstrap_transport(0, size, port=0, **kw)
        for _ in range(size - 1):
            port_q.put(tr.port)
        return tr
    try:
        port = port_q.get(timeout=timeout)
    except _queue.Empty:
        raise TimeoutError(f"rank {rank}: no rendezvous port within {timeout}s") from None
    return bootstrap_transport(rank, size, port=port, **kw)


def _collect(procs, q, want: int, deadline: float, *, skip: Optional[int] = None) -> dict:
    """``want`` ``(rank, report)`` items from ``q`` before ``deadline``
    (``TimeoutError`` after it); raises as soon as a rank other than
    ``skip`` exits with an error."""
    results: dict[int, Any] = {}
    while len(results) < want and time.monotonic() < deadline:
        try:
            rank, report = q.get(timeout=1.0)
        except _queue.Empty:
            bad = [
                (p.name, p.exitcode)
                for i, p in enumerate(procs)
                if i != skip and p.exitcode not in (None, 0)
            ]
            if bad:
                raise RuntimeError(f"a rank process died: {bad}")
            continue
        if rank == skip:  # pragma: no cover - the kill was too slow
            raise RuntimeError("the victim survived and reported")
        results[rank] = report
    if len(results) < want:
        raise TimeoutError(f"only {len(results)}/{want} ranks reported in time")
    return results


def _reap(procs) -> None:
    for p in procs:
        p.join(timeout=10.0)
        if p.is_alive():  # pragma: no cover - hung rank
            p.terminate()
            p.join(timeout=5.0)


def _warm_up(tg, group, dev) -> None:
    """A one-element all-reduce before anything is timed: every rank is up,
    and the ring's links are dialed."""
    import torch

    from repro_torch.core import SpData
    from repro_torch.dist.collectives import ring_all_reduce

    ring_all_reduce(tg, group, SpData(torch.zeros(1, device=dev), "warm"), tag="warm")
    tg.wait_all_tasks()


# ---------------------------------------------------------------------------
# Ring reduce: random normal inputs, checked against the ring's own order.
# ---------------------------------------------------------------------------

def _normal_input(rank: int, n: int) -> np.ndarray:
    return np.random.default_rng(rank).standard_normal(n).astype(np.float32)


def ring_order_sum(arrays: list) -> np.ndarray:
    """The flat ring all-reduce's sum in NumPy, element for element in the
    ring's own order: chunk ``c`` (``np.array_split`` of the flat array
    into ``S`` parts) starts at rank ``c`` and every next rank adds its
    own chunk to what arrives, ``x[c+1] + x[c]``, then
    ``x[c+2] + (x[c+1] + x[c])``, ….  Bit for bit what
    :func:`~repro_torch.dist.collectives.ring_all_reduce` gives at any
    rank count and any ``chunk_bytes`` (pieces keep the order)."""
    S = len(arrays)
    flats = [np.asarray(a).reshape(-1) for a in arrays]
    bounds = np.cumsum([0] + [len(p) for p in np.array_split(flats[0], S)])
    out = np.empty_like(flats[0])
    for c in range(S):
        lo, hi = bounds[c], bounds[c + 1]
        acc = flats[c][lo:hi]
        for k in range(1, S):
            acc = flats[(c + k) % S][lo:hi] + acc
        out[lo:hi] = acc
    return out.reshape(np.asarray(arrays[0]).shape)


def _ring_worker(rank, size, n, steps, q, port_q, device, transport, use_digest) -> None:
    """One rank: all-reduce ``steps`` times over TCP (sum first, then mean
    on a fresh cell), report values + wall time + transport stats."""
    import torch

    from repro_torch.core import (
        SpCommGroup,
        SpComputeEngine,
        SpData,
        SpTaskGraph,
        SpWorkerTeamBuilder,
    )
    from repro_torch.dist.collectives import ring_all_reduce

    dev = _rank_device(device)
    base = torch.from_numpy(_normal_input(rank, n)).to(dev)
    tr = _join(rank, size, port_q, transport=transport)
    eng = SpComputeEngine(SpWorkerTeamBuilder.team_of_cpu_workers(2))
    try:
        group = SpCommGroup(rank, size, tr, default_timeout=120.0, device=dev)
        tg = SpTaskGraph(trace=False).compute_on(eng)
        _warm_up(tg, group, dev)
        walls = []
        x = SpData(None, f"sum{rank}")
        for step in range(steps):  # distinct per-step tags
            x.value = base.clone()
            t0 = time.perf_counter()
            ring_all_reduce(tg, group, x, op="sum", tag=step)
            tg.wait_all_tasks()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
        y = SpData(base.clone(), f"mean{rank}")
        ring_all_reduce(tg, group, y, op="mean", tag=steps)
        tg.wait_all_tasks()
        t0 = time.perf_counter()
        base.to("cpu")  # the D2H copy of one whole payload, timed apart
        d2h = time.perf_counter() - t0
        q.put((rank, {
            "sum": _report(x.value, use_digest), "mean": _report(y.value, use_digest),
            "device": _device_of(x.value), "wall_s": float(np.median(walls)),
            "walls": walls, "d2h_s": d2h, "stats": tr.stats(),
        }))
    finally:
        eng.stop()
        tr.close()


def run_ring_reduce(
    size: int = 2,
    n: int = 4099,
    *,
    steps: int = 1,
    timeout: float = 120.0,
    device="cuda",
    transport: str = "p2p",
    digest: bool = False,
) -> dict:
    """Spawn ``size`` rank processes, ring-all-reduce a ``float32[n]``
    (``np.random.default_rng(rank).standard_normal``, on ``device``) over
    ``transport`` ``steps`` times, plus one mean reduce, and return
    ``{rank: {"sum", "mean", "device", "wall_s", "walls", "d2h_s",
    "stats"}}``.  ``n`` defaults to a size-indivisible length so chunking
    is exercised; ``wall_s`` is the median sum reduce."""
    _check_device(device)
    ctx = mp.get_context("spawn")
    q: Any = ctx.Queue()
    procs, _port_q = _spawn_ranks(
        _ring_worker, size,
        lambda r, port_q: (r, size, n, steps, q, port_q, device, transport, digest),
    )
    try:
        return _collect(procs, q, size, time.monotonic() + timeout)
    finally:
        _reap(procs)


# ---------------------------------------------------------------------------
# Collectives on exact (integer-valued) inputs.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=2)
def _det_base(n: int) -> np.ndarray:
    base = np.arange(n, dtype=np.float32) % 31.0
    base.setflags(write=False)
    return base


def _det_grad(rank: int, step: int, n: int):
    """Deterministic, *integer-valued* float32 pseudo-gradient.  Integer
    values below 2**24 make float32 addition exact and associative, so the
    ring reduction matches a plain NumPy sum bit-for-bit at any rank count
    and in any accumulation order — the survivors-only oracle can be exact
    even across the pre-failure full-mesh steps."""
    return _det_base(n) + np.float32((rank + 1) * (step + 3))


def _collective_worker(rank, size, n, kind, kwargs, q, port_q, device, transport,
                       use_digest) -> None:
    """One rank of :func:`run_collective`: run the requested collective on
    :func:`_det_grad` and report the result + wall time + transport stats."""
    import torch

    from repro_torch.core import (
        SpCommGroup,
        SpComputeEngine,
        SpData,
        SpTaskGraph,
        SpWorkerTeamBuilder,
    )
    from repro_torch.dist.collectives import (
        hierarchical_all_reduce,
        ring_all_gather,
        ring_all_reduce,
    )

    dev = _rank_device(device)
    x = SpData(torch.from_numpy(_det_grad(rank, 0, n)).to(dev), f"coll{rank}")
    tr = _join(rank, size, port_q, transport=transport)
    eng = SpComputeEngine(SpWorkerTeamBuilder.team_of_cpu_workers(2))
    try:
        group = SpCommGroup(rank, size, tr, default_timeout=120.0, device=dev)
        tg = SpTaskGraph(trace=False).compute_on(eng)
        _warm_up(tg, group, dev)
        t0 = time.perf_counter()
        if kind == "ring":
            view = ring_all_reduce(tg, group, x, **kwargs)
        elif kind == "hier":
            view = hierarchical_all_reduce(tg, group, x, **kwargs)
        elif kind == "gather":
            view = ring_all_gather(tg, group, x, **kwargs)
        else:
            raise ValueError(f"unknown collective kind {kind!r}")
        tg.wait_all_tasks()
        value = view.get_value()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        q.put((rank, {
            "value": _report(value, use_digest), "device": _device_of(value),
            "wall_s": wall, "stats": tr.stats(),
        }))
    finally:
        eng.stop()
        tr.close()


def run_collective(
    size: int,
    n: int = 4099,
    *,
    kind: str = "ring",
    timeout: float = 240.0,
    device="cuda",
    transport: str = "p2p",
    digest: bool = False,
    **kwargs,
) -> dict:
    """Spawn ``size`` rank processes over ``transport`` and run one
    collective (``kind="ring"`` → :func:`ring_all_reduce` with e.g.
    ``chunk_bytes=...``; ``"hier"`` → :func:`hierarchical_all_reduce` with
    ``pod_size=...``; ``"gather"`` → :func:`ring_all_gather`).  Inputs are
    :func:`_det_grad` per rank on ``device`` — integer-valued float32, so
    results are bit-exact against any honest-sum oracle.  Returns
    ``{rank: {"value", "device", "wall_s", "stats"}}``."""
    _check_device(device)
    ctx = mp.get_context("spawn")
    q: Any = ctx.Queue()
    procs, _port_q = _spawn_ranks(
        _collective_worker, size,
        lambda r, port_q: (r, size, n, kind, kwargs, q, port_q, device, transport, digest),
    )
    try:
        return _collect(procs, q, size, time.monotonic() + timeout)
    finally:
        _reap(procs)


# ---------------------------------------------------------------------------
# Elastic runs: SIGKILL a rank mid-collective, the runtime recovers.
# ---------------------------------------------------------------------------

def _elastic_worker(rank, size, n, steps, q, progress_q, port_q, device, use_digest,
                    hb_timeout: float = 3.0, victim_hold=None) -> None:
    """One elastic rank: all-reduce ``steps`` times, surviving rank death.

    Recovery lives in the *runtime*: ``SpRuntime(elastic=True)`` gives
    every step a fresh task graph, catches the rank death escaping the
    step (the failed graph's lingering receives time out harmlessly on the
    comm thread), drives :func:`reroll_ranks` internally and resumes from
    the minimum exchanged step on the shrunken ring.  This worker has no
    failure handling of its own."""
    import torch

    from repro_torch.core import SpCommGroup, SpData, SpRuntime
    from repro_torch.dist.collectives import ring_all_reduce

    dev = _rank_device(device)
    base = torch.from_numpy(_normal_input(rank, n)).to(dev)
    tr = _join(rank, size, port_q, heartbeat_interval=0.2, heartbeat_timeout=hb_timeout)
    try:
        group = SpCommGroup(rank, size, tr, default_timeout=30.0, device=dev)

        with SpRuntime(workers=2, elastic=True, group=group) as rt:

            def step_fn(step: int):
                x = SpData(base.clone(), f"e{rt.epoch}s{step}")
                ring_all_reduce(rt.graph, rt.group, x, op="sum", tag=(rt.epoch, step))
                # progress is reported *after* the collective is inserted —
                # its comm tasks are already in flight on the engine's
                # background threads, so a parent killing on this report
                # kills mid-collective
                progress_q.put(("step", rank, step))
                if victim_hold is not None and step == victim_hold[0]:
                    # the designated victim lingers inside the collective so
                    # the parent's SIGKILL reliably lands mid-flight
                    time.sleep(victim_hold[1])
                rt.barrier(timeout=60.0)
                return x.value

            results = rt.elastic_loop(step_fn, steps, step_timeout=60.0)
            rec = rt.recoveries[-1] if rt.recoveries else {}
            q.put((rank, {
                "steps": {s: _report(v, use_digest) for s, v in results.items()},
                "device": _device_of(results[steps - 1]),
                "resume_step": rec.get("resume"),
                "detect_at": rec.get("detect_at"),
                "reroll_s": rec.get("reroll_s"),
                "members": list(rt.group.members),
                "dead": sorted(tr.dead_ranks),
                "stats": tr.stats(),
            }))
    finally:
        tr.close()


def _kill_when_reached(procs, progress_q, victim: int, fail_at: int, kill_delay: float,
                       deadline: float) -> float:
    """Watch progress until the victim enters step ``fail_at``, SIGKILL it,
    and return the ``time.monotonic()`` of the kill."""
    while time.monotonic() < deadline:
        try:
            kind, rank, step = progress_q.get(timeout=1.0)
        except _queue.Empty:
            continue
        if kind == "step" and rank == victim and step == fail_at:
            time.sleep(kill_delay)  # let its sends enter the collective
            t_kill = time.monotonic()
            os.kill(procs[victim].pid, signal.SIGKILL)
            return t_kill
    raise TimeoutError(f"victim rank {victim} never reached step {fail_at}")


def run_elastic_ring(
    size: int = 3,
    n: int = 257,
    *,
    steps: int = 4,
    fail_at: int = 2,
    timeout: float = 180.0,
    kill_delay: float = 0.02,
    victim_hold_s: float = 2.0,
    victim: int | None = None,
    device="cuda",
    digest: bool = False,
) -> tuple[dict, dict]:
    """Spawn ``size`` rank processes, SIGKILL ``victim`` (default: the
    highest rank) as it enters step ``fail_at``'s all-reduce, and return
    the survivors' reports.

    ``victim=0`` kills the rendezvous rank itself — legal on the p2p data
    plane, where the address book is already distributed and the survivors
    detect the death over their *direct* links (no router in the path).

    Returns ``(results, info)``: ``results[rank]`` is each survivor's
    report from :func:`_elastic_worker`; ``info`` records the victim and
    the parent's ``time.monotonic()`` at the moment of the kill, so
    detection latency is ``report["detect_at"] - info["t_kill"]``
    (CLOCK_MONOTONIC is machine-wide on Linux)."""
    if size < 3:
        raise ValueError("need >= 3 ranks: two survivors must agree on the dead set")
    _check_device(device)
    if victim is None:
        victim = size - 1
    ctx = mp.get_context("spawn")
    q: Any = ctx.Queue()
    progress_q: Any = ctx.Queue()

    def args_of(r, port_q):
        hold = (fail_at, victim_hold_s) if r == victim else None
        return (r, size, n, steps, q, progress_q, port_q, device, digest, 3.0, hold)

    procs, _port_q = _spawn_ranks(_elastic_worker, size, args_of)
    deadline = time.monotonic() + timeout
    info: dict[str, Any] = {"victim": victim, "t_kill": None}
    try:
        info["t_kill"] = _kill_when_reached(procs, progress_q, victim, fail_at, kill_delay,
                                            deadline)
        results = _collect(procs, q, size - 1, deadline, skip=victim)
    finally:
        _reap(procs)
    return results, info


def _sgd_update(params, grad_sum, n_ranks: int, lr: float):
    """One data-parallel SGD step: ``params - lr * mean(grads)``, all in
    float32: one division and one multiply-subtract pair, each rounded to
    float32, on NumPy arrays (the oracle) or tensors (the ranks) alike, so
    bit-exactness is by construction, not by matching promotions by hand."""
    lr32 = np.float32(lr)
    if isinstance(params, np.ndarray):
        mean = grad_sum / np.float32(n_ranks)
        return (params - lr32 * mean).astype(np.float32)
    mean = grad_sum / float(n_ranks)
    return params - float(lr32) * mean


def _train_worker(rank, size, n, steps, lr, q, progress_q, port_q, device, use_digest,
                  hb_timeout: float = 3.0, victim_hold=None) -> None:
    """One elastic *training* rank: a plain data-parallel SGD loop with no
    try/except and no recovery code — surviving a SIGKILLed peer is entirely
    ``SpRuntime(elastic=True)``'s job.

    Params are kept per step (``history[step]``) so a rewind to an earlier
    resume step re-executes from exactly the params that step saw — state
    indexing, not failure handling."""
    import torch

    from repro_torch.core import SpCommGroup, SpData, SpRuntime
    from repro_torch.dist.collectives import ring_all_reduce

    dev = _rank_device(device)
    tr = _join(rank, size, port_q, heartbeat_interval=0.2, heartbeat_timeout=hb_timeout)
    try:
        group = SpCommGroup(rank, size, tr, default_timeout=30.0, device=dev)
        history: dict[int, Any] = {0: torch.zeros(n, dtype=torch.float32, device=dev)}

        with SpRuntime(workers=2, elastic=True, group=group) as rt:

            def train_step(step: int):
                params = history[step]
                g = SpData(torch.from_numpy(_det_grad(rank, step, n)).to(dev),
                           f"g{rank}e{rt.epoch}s{step}")
                ring_all_reduce(rt.graph, rt.group, g, op="sum", tag=(rt.epoch, step))
                progress_q.put(("step", rank, step))
                if victim_hold is not None and step == victim_hold[0]:
                    time.sleep(victim_hold[1])
                rt.barrier(timeout=60.0)
                new_params = _sgd_update(params, g.value, len(rt.group.members), lr)
                history[step + 1] = new_params
                return new_params

            rt.elastic_loop(train_step, steps, step_timeout=60.0)
            rec = rt.recoveries[-1] if rt.recoveries else {}
            q.put((rank, {
                "params": _report(history[steps], use_digest),
                "device": _device_of(history[steps]),
                "resume_step": rec.get("resume"),
                "detect_at": rec.get("detect_at"),
                "reroll_s": rec.get("reroll_s"),
                "members": list(rt.group.members),
                "dead": sorted(tr.dead_ranks),
                "recoveries": len(rt.recoveries),
            }))
    finally:
        tr.close()


def run_elastic_train(
    size: int = 3,
    n: int = 257,
    *,
    steps: int = 5,
    fail_at: int = 2,
    lr: float = 0.01,
    timeout: float = 180.0,
    kill_delay: float = 0.02,
    victim_hold_s: float = 2.0,
    device="cuda",
    digest: bool = False,
) -> tuple[dict, dict]:
    """SIGKILL a real OS rank mid-*training* and let the runtime recover.

    Spawns ``size`` rank processes running :func:`_train_worker`'s plain SGD
    loop under ``SpRuntime(elastic=True)`` on ``device``, kills the highest
    rank as it enters step ``fail_at``'s all-reduce, and returns the
    survivors' reports (final params, recovery record).  The expected final
    params are :func:`elastic_train_oracle` with the resume step from any
    survivor — bit-exact, because the pseudo-gradients are integer-valued."""
    if size < 3:
        raise ValueError("need >= 3 ranks: two survivors must agree on the dead set")
    _check_device(device)
    victim = size - 1
    ctx = mp.get_context("spawn")
    q: Any = ctx.Queue()
    progress_q: Any = ctx.Queue()

    def args_of(r, port_q):
        hold = (fail_at, victim_hold_s) if r == victim else None
        return (r, size, n, steps, lr, q, progress_q, port_q, device, digest, 3.0, hold)

    procs, _port_q = _spawn_ranks(_train_worker, size, args_of)
    deadline = time.monotonic() + timeout
    info: dict[str, Any] = {"victim": victim, "t_kill": None}
    try:
        info["t_kill"] = _kill_when_reached(procs, progress_q, victim, fail_at, kill_delay,
                                            deadline)
        results = _collect(procs, q, size - 1, deadline, skip=victim)
    finally:
        _reap(procs)
    return results, info


def elastic_train_oracle(
    size: int,
    n: int,
    steps: int,
    lr: float,
    *,
    resume_step: int,
    dead: tuple[int, ...] = (),
):
    """Replay the elastic SGD run in plain NumPy: full-mesh mean-reduced
    steps before ``resume_step``, survivors-only after.  Bit-exact against
    :func:`_train_worker` because both use :func:`_det_grad` /
    :func:`_sgd_update` and the gradients are integer-valued float32."""
    params = np.zeros(n, dtype=np.float32)
    for step in range(steps):
        ranks = [
            r
            for r in range(size)
            if step < resume_step or r not in set(dead)
        ]
        gsum = np.zeros(n, dtype=np.float32)
        for r in ranks:
            gsum = gsum + _det_grad(r, step, n)
        params = _sgd_update(params, gsum, len(ranks), lr)
    return params


def main(argv=None) -> dict:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", type=int, default=2)
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    results = run_ring_reduce(args.size, args.n, steps=args.steps, device=args.device)
    expected = ring_order_sum([_normal_input(r, args.n) for r in range(args.size)])
    nbytes = 4 * args.n
    for rank, res in sorted(results.items()):
        exact = bool(np.array_equal(res["sum"], expected))
        busbw = 2 * (args.size - 1) / args.size * nbytes / res["wall_s"]
        print(
            f"[rank {rank}] allreduce float32[{args.n}] on {res['device']} x{args.steps}: "
            f"{res['wall_s'] * 1e3:.1f} ms/step (median), bus {busbw / 1e9:.3f} GB/s, "
            f"D2H of the payload {res['d2h_s'] * 1e3:.1f} ms, bitexact={exact}, "
            f"transport={res['stats']}"
        )
        if not exact:
            raise AssertionError(f"rank {rank}: the sum differs from the ring-order oracle")
    return results


if __name__ == "__main__":
    main()
