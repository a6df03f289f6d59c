"""The port's fault handling (``repro_torch.dist.fault``, the dead-rank
semantics of ``repro_torch.core.comm``, ``reroll_ranks`` and the elastic
``SpRuntime``) against ``repro``'s: seeded fault schedules, retries, the
re-mesh plan, failure detection on sockets (ranks as threads), the local
elastic loop, and one spawned 3-rank ``run_elastic_train`` whose survivors
equal ``elastic_train_oracle`` bit for bit."""
from __future__ import annotations

import socket
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.dist.collectives as jcoll  # noqa: E402
import repro.dist.fault as jfault  # noqa: E402
from repro.core.comm import _resolve_hb_knobs as j_resolve_hb_knobs  # noqa: E402
from repro.launch import rendezvous as jrdv  # noqa: E402
import repro_torch.core as core  # noqa: E402
import repro_torch.dist.fault as fault  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ChannelHub,
    ElasticEvent,
    SocketTransport,
    SpCommAbortedError,
    SpCommError,
    SpCommGroup,
    SpCommTimeoutError,
    SpCommTransientError,
    SpComputeEngine,
    SpData,
    SpRankDeadError,
    SpRead,
    SpRuntime,
    SpTaskGraph,
    SpWorkerTeamBuilder,
    SpWrite,
    mpi_broadcast,
    mpi_recv,
)
from repro_torch.core.comm import _resolve_hb_knobs  # noqa: E402
from repro_torch.dist import collectives as coll  # noqa: E402
from repro_torch.dist.fault import (  # noqa: E402
    CancelToken,
    FailureSimulator,
    FaultyTransport,
    RetryingTransport,
    remesh_plan,
    run_duplicated,
)
from repro_torch.launch import rendezvous as rdv  # noqa: E402


@pytest.fixture()
def engine():
    eng = SpComputeEngine(SpWorkerTeamBuilder.team_of_cpu_workers(4))
    yield eng
    eng.stop()


# ---------------------------------------------------------------------------
# error taxonomy and dead-rank semantics on the mailbox layer
# ---------------------------------------------------------------------------

def test_every_comm_error_derives_from_sp_comm_error():
    for exc_type in (SpCommTimeoutError, SpCommAbortedError, SpRankDeadError, SpCommTransientError):
        assert issubclass(exc_type, SpCommError)
    hub = ChannelHub()
    hub.mark_dead(1)
    with pytest.raises(SpCommError):
        hub.post((0, 1, "t"), 1)
    with pytest.raises(SpCommError):
        hub.poll((1, 0, "t"))
    with pytest.raises(SpCommError):
        FaultyTransport(ChannelHub(), seed=0, flaky={1: 1}).post((0, 1, "t"), 1)


def test_dead_rank_semantics():
    """Post to and empty poll from a dead rank raise; what it posted before
    dying still drains; the first death stamp sticks; reset clears."""
    hub = ChannelHub()
    hub.post((2, 0, "x"), torch.ones(2))
    hub.mark_dead(2)
    stamp = hub.death_detected_at(2)
    assert hub.is_dead(2) and stamp is not None
    with pytest.raises(SpRankDeadError, match="rank 2"):
        hub.post((0, 2, "x"), 1)
    ok, msg = hub.poll((2, 0, "x"))
    assert ok and torch.equal(msg, torch.ones(2))
    with pytest.raises(SpRankDeadError, match="rank 2"):
        hub.poll((2, 0, "x"))
    time.sleep(0.01)
    hub.mark_dead(2)
    assert hub.death_detected_at(2) == stamp
    hub.reset()
    assert hub.dead_ranks == frozenset()


@pytest.mark.parametrize("when", ["pending", "future"])
def test_recv_from_dead_rank_fails_fast_and_cancels_dependents(engine, when):
    hub = ChannelHub()
    tg = SpTaskGraph().compute_on(engine)
    r, out = SpData(None, "r"), SpData("untouched", "out")
    if when == "future":
        hub.mark_dead(0)
    # a generous timeout: only the death can end this recv quickly
    view = mpi_recv(tg, SpCommGroup(1, 2, hub), r, src=0, tag="dead", timeout=60.0)
    dep = tg.task(SpRead(r), SpWrite(out), lambda v, ref: setattr(ref, "value", v))
    if when == "pending":
        time.sleep(0.05)
        hub.mark_dead(0)
    start = time.monotonic()
    assert isinstance(view.exception(timeout=10.0), SpRankDeadError)
    assert time.monotonic() - start < 5.0
    tg.wait_all_tasks(timeout=10.0)
    assert dep.state == "cancelled" and out.value == "untouched"


def test_engine_stop_is_idempotent_with_aborted_requests():
    eng = SpComputeEngine(SpWorkerTeamBuilder.team_of_cpu_workers(1))
    tg = SpTaskGraph().compute_on(eng)
    mpi_recv(tg, SpCommGroup(1, 2, ChannelHub()), SpData(None, "r"), src=0, tag=13)
    deadline = time.monotonic() + 5.0
    while eng._comm is None and time.monotonic() < deadline:
        time.sleep(0.005)
    with pytest.warns(RuntimeWarning, match="in-flight"):
        first = eng.stop()
    assert first == ["recv(from=0,tag=13)"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a second stop must not re-warn
        assert eng.stop() == first
    tg.wait_all_tasks(timeout=5.0, raise_errors=False)


# ---------------------------------------------------------------------------
# fault injection and retry: repro's schedules, repro's results
# ---------------------------------------------------------------------------

def _fault_schedule(mod, hub, seed: int, n: int = 60, payload=lambda i: i):
    ft = mod.FaultyTransport(hub, seed=seed, drop=0.3, duplicate=0.2, delay=0.1,
                             truncate=0.1, delay_s=0.001)
    outcomes = []
    for i in range(n):
        try:
            ft.post((0, 1, i), payload(i))
            outcomes.append("ok")
        except Exception as e:  # noqa: BLE001 - the kind is what is compared
            outcomes.append(type(e).__name__)
    return outcomes, dict(ft.injected)


@pytest.mark.parametrize("seed", [0, 42])
def test_faulty_transport_schedule_equals_repro(seed):
    """A seed gives the same fault schedule on both packages (and again on
    the port), whatever the payloads are; a different seed another."""
    got = _fault_schedule(fault, ChannelHub(), seed,
                          payload=lambda i: torch.full((3,), float(i)))
    want = _fault_schedule(jfault, jcore.ChannelHub(), seed)
    assert got == want
    assert got == _fault_schedule(fault, ChannelHub(), seed)
    assert got[1]["dropped"] > 0 and got[1]["truncated"] > 0
    assert _fault_schedule(jfault, jcore.ChannelHub(), seed + 1)[0] != got[0]


def test_faulty_transport_dedups_duplicates_and_discards_corrupt():
    ft = FaultyTransport(ChannelHub(), seed=7, duplicate=1.0, truncate=0.0)
    for i in range(10):
        ft.post((0, 1, i), torch.tensor(i))
    for i in range(10):
        ok, msg = ft.poll((0, 1, i))
        assert ok and int(msg) == i
        assert not ft.poll((0, 1, i))[0]  # the duplicate is filtered
    assert ft.injected["duplicated"] == ft.injected["deduped"] == 10
    bad = FaultyTransport(ChannelHub(), seed=0, truncate=1.0)
    with pytest.raises(SpCommTransientError):
        bad.post((0, 1, "t"), 1)
    assert not bad.poll((0, 1, "t"))[0] and bad.injected["corrupt_discarded"] == 1


def test_retrying_transport_absorbs_transients_and_flaky_ranks():
    ft = FaultyTransport(ChannelHub(), seed=1, drop=0.4, delay_s=0.001)
    rt = RetryingTransport(ft, max_retries=25, backoff=0.0002)
    for i in range(30):
        rt.post((0, 1, i), {"v": torch.tensor(i)})
    for i in range(30):
        ok, msg = ft.poll((0, 1, i))
        assert ok and int(msg["v"]) == i
    assert rt.retries > 0 and rt.escalations == 0
    flaky = RetryingTransport(FaultyTransport(ChannelHub(), seed=0, flaky={1: 3}),
                              max_retries=5, backoff=0.0001)
    flaky.post((0, 1, "a"), 1)
    assert flaky.retries == 3 and flaky.poll((0, 1, "a")) == (True, 1)


def test_retry_budget_exhaustion_escalates_and_kill_plan_kills():
    hub = ChannelHub()
    rt = RetryingTransport(FaultyTransport(hub, seed=0, flaky={2: 100}), max_retries=3,
                           backoff=0.0001)
    with pytest.raises(SpRankDeadError, match="rank 2"):
        rt.post((0, 2, "x"), 1)
    assert rt.escalations == 1 and hub.is_dead(2)
    with pytest.raises(SpRankDeadError):
        rt.post((0, 2, "y"), 1)
    ft = FaultyTransport(ChannelHub(), seed=0, kill_plan={2: 5})
    ft.post((0, 1, 0), 0)
    ft.post((0, 1, 1), 1)
    with pytest.raises(SpRankDeadError):
        ft.post((0, 5, 2), 2)  # post ordinal 2 kills rank 5 first
    assert ft.is_dead(5)


def _faulty_ring(cm, dm, fm, arrays, wrap):
    size = len(arrays)
    eng = cm.SpComputeEngine(cm.SpWorkerTeamBuilder.team_of_cpu_workers(4))
    try:
        hub = cm.ChannelHub()
        trs = [fm.RetryingTransport(
            fm.FaultyTransport(hub, seed=r, drop=0.15, duplicate=0.15, delay=0.1, delay_s=0.001),
            max_retries=30, backoff=0.0002) for r in range(size)]
        groups = [cm.SpCommGroup(r, size, trs[r], default_timeout=60.0) for r in range(size)]
        graphs = [cm.SpTaskGraph().compute_on(eng) for _ in range(size)]
        cells = [cm.SpData(wrap(a.copy()), f"f{r}") for r, a in enumerate(arrays)]
        for r in range(size):
            dm.ring_all_reduce(graphs[r], groups[r], cells[r], op="sum", chunk_bytes=16)
        for g in graphs:
            g.wait_all_tasks(timeout=120.0)
        return [np.asarray(c.value) for c in cells], [t.retries for t in trs]
    finally:
        eng.stop()


def test_ring_all_reduce_under_drops_delays_duplicates_equals_repro():
    """The full stack, ring all-reduce over Retrying(Faulty(hub)) with drops,
    delays and duplicates: the port's sums equal repro's bit for bit (and
    the fault-free ring order)."""
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(37).astype(np.float32) for _ in range(3)]
    got, retries = _faulty_ring(core, coll,
                                fault, arrays,
                                torch.from_numpy)
    want, _ = _faulty_ring(jcore, jcoll, jfault, arrays, lambda a: a)
    assert sum(retries) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, rdv.ring_order_sum(arrays))


# ---------------------------------------------------------------------------
# socket failure detection (ranks as threads)
# ---------------------------------------------------------------------------

def test_socket_eof_death_detection_and_survivor_traffic():
    """A hangup without the goodbye frame (what a SIGKILL looks like on the
    wire) is declared dead everywhere within milliseconds; the surviving
    pair keeps exchanging tensors."""
    t0 = SocketTransport(0, 3)
    t1 = SocketTransport(1, 3, port=t0.port)
    t2 = SocketTransport(2, 3, port=t0.port)
    try:
        t2._hb_stop.set()
        with pytest.warns(RuntimeWarning, match="dead"):
            t2._sock.shutdown(socket.SHUT_RDWR)  # FIN without a bye
            deadline = time.monotonic() + 5.0
            while not (t0.is_dead(2) and t1.is_dead(2)):
                assert time.monotonic() < deadline, "death never detected"
                time.sleep(0.002)
        with pytest.raises(SpRankDeadError):
            t0.poll((2, 0, "never"))
        with pytest.raises(SpRankDeadError):
            t1.post((1, 2, "x"), 1)
        t0.post((0, 1, "z"), torch.arange(3))
        deadline = time.monotonic() + 5.0
        while not (got := t1.poll((0, 1, "z")))[0]:
            assert time.monotonic() < deadline
            time.sleep(0.002)
        assert torch.equal(got[1], torch.arange(3))
    finally:
        for t in (t2, t1, t0):
            t.close()


def test_socket_heartbeat_staleness_death_detection():
    ta = SocketTransport(0, 2, heartbeat_interval=0.05, heartbeat_timeout=0.4)
    tb = SocketTransport(1, 2, port=ta.port, heartbeat_interval=0.05, heartbeat_timeout=0.4)
    try:
        time.sleep(0.15)
        with pytest.warns(RuntimeWarning, match="no heartbeat"):
            tb._hb_stop.set()  # wedged: TCP alive, heartbeats gone
            stale_t = time.monotonic()
            while not ta.is_dead(1):
                assert time.monotonic() < stale_t + 5.0, "staleness never detected"
                time.sleep(0.005)
        assert ta.death_detected_at(1) - stale_t < 2.0
    finally:
        tb.close()
        ta.close()


def test_socket_dial_failure_is_bounded_and_names_the_address():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free_port = s.getsockname()[1]
    start = time.monotonic()
    with pytest.raises(SpCommError, match=rf"127\.0\.0\.1:{free_port}"):
        SocketTransport(1, 2, port=free_port, connect_timeout=0.5, max_dial_retries=5)
    assert time.monotonic() - start < 5.0


@pytest.mark.parametrize("kw", [
    dict(heartbeat=0.1, staleness_factor=5.0), dict(heartbeat_interval=0.3),
    dict(heartbeat_timeout=2.0), {}, dict(heartbeat=0.1, heartbeat_interval=0.2),
    dict(heartbeat_timeout=3.0, staleness_factor=4.0), dict(heartbeat=0.0),
])
def test_heartbeat_knobs_resolve_as_repro(kw):
    full = dict(heartbeat=None, staleness_factor=None, heartbeat_interval=None,
                heartbeat_timeout=None) | kw
    try:
        want = j_resolve_hb_knobs(**full)
    except ValueError:
        with pytest.raises(ValueError):
            _resolve_hb_knobs(**full)
        return
    assert _resolve_hb_knobs(**full) == want


# ---------------------------------------------------------------------------
# shrunken groups and re-roll agreement
# ---------------------------------------------------------------------------

def test_group_members_and_shrunk():
    g = SpCommGroup(2, 4, ChannelHub(), device="cpu")
    assert g.members == (0, 1, 2, 3) and (g.logical_rank, g.logical_size) == (2, 4)
    s = g.shrunk([1, 3])
    assert s.members == (0, 2) and (s.logical_rank, s.logical_size) == (1, 2)
    assert s.to_physical(s.logical_rank + 1) == 0 and s.device == g.device
    with pytest.raises(SpCommError):
        g.shrunk([2])
    with pytest.raises(ValueError):
        SpCommGroup(5, 4, ChannelHub(), members=(0, 1))


def test_broadcast_on_shrunken_group(engine):
    hub = ChannelHub()
    groups = {r: SpCommGroup(r, 3, hub, default_timeout=30.0).shrunk([1]) for r in (0, 2)}
    graphs = {r: SpTaskGraph().compute_on(engine) for r in (0, 2)}
    cells = {r: SpData(torch.arange(4.0) if r == 0 else None, f"b{r}") for r in (0, 2)}
    for r in (0, 2):
        mpi_broadcast(graphs[r], groups[r], cells[r], root=0)
    for g in graphs.values():
        g.wait_all_tasks(timeout=60.0)
    assert torch.equal(cells[2].value, torch.arange(4.0))
    assert not any(key[1] == 1 for key in hub._boxes)


def test_reroll_ranks_agreement():
    hub = ChannelHub()
    hub.mark_dead(2)
    groups = {r: SpCommGroup(r, 3, hub, default_timeout=30.0) for r in (0, 1)}
    out: dict = {}

    def roll(r, payload):
        out[r] = rdv.reroll_ranks(groups[r], epoch=1, payload=payload, timeout=10.0)

    threads = [threading.Thread(target=roll, args=(0, {"next_step": 5})),
               threading.Thread(target=roll, args=(1, {"next_step": 4}))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=15.0)
    assert set(out) == {0, 1}
    for r in (0, 1):
        new_group, dead, payloads = out[r]
        assert dead == frozenset({2}) and new_group.members == (0, 1)
        assert {p["next_step"] for p in payloads.values()} == {4, 5}


# ---------------------------------------------------------------------------
# duplicated tasks, FailureSimulator, remesh_plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["cancels losers", "masks a crash", "all fail"])
def test_run_duplicated(case):
    eng = SpComputeEngine(SpWorkerTeamBuilder.team_of_cpu_workers(1))
    try:
        tg = SpTaskGraph().compute_on(eng)
        out = SpData(None, "out")
        if case == "cancels losers":
            # one worker: copy0 wins, the others cancel at their token check
            view = run_duplicated(tg, lambda v: v * 3, [SpData(torch.tensor(7), "x")], out,
                                  n=3, name="dup")
            tg.wait_all_tasks()
            assert int(view.get_value()) == 21 and int(out.value) == 21
            states = sorted(t.state for t in tg.tasks if t.name.startswith("dup.copy"))
            assert states == ["cancelled", "cancelled", "finished"]
        elif case == "masks a crash":
            calls = []

            def flaky(v):
                calls.append(1)
                if len(calls) == 1:
                    raise RuntimeError("injected replica crash")
                return v + 1

            view = run_duplicated(tg, flaky, [SpData(5, "x")], out, n=3, name="flaky")
            tg.wait_all_tasks()
            assert view.get_value() == 6
        else:
            def boom():
                raise RuntimeError("boom")

            run_duplicated(tg, boom, [], out, n=2, name="doomed")
            with pytest.raises(RuntimeError, match="all 2 duplicated copies failed"):
                tg.wait_all_tasks()
    finally:
        eng.stop()
    tok = CancelToken()
    assert tok.set("a") and not tok.set("b") and tok.winner == "a" and tok.wait(0.01)


def test_failure_simulator_equals_repro():
    for plan, flaky in (({0: 2, 3: 1}, None), ({}, {2: 3}), ({1: 1}, {1: 2, 6: 1})):
        sims = FailureSimulator(plan, flaky=flaky), jfault.FailureSimulator(plan, flaky=flaky)
        trace = [[(s.check(step), s.flaky_down(step)) for step in range(9)] for s in sims]
        assert trace[0] == trace[1]
        assert (sims[0].events, sims[0].flaky_events, sims[0].total_lost) == (
            sims[1].events, sims[1].flaky_events, sims[1].total_lost)


def test_remesh_plan_equals_repro_over_a_grid():
    n = 0
    for n_total in (1, 2, 4, 8, 16, 64, 512):
        for n_failed in range(0, n_total + 1, max(1, n_total // 8)):
            for mp_ in (1, 2, 4, 16):
                for pod in (None, 4, 16, 40, 64):
                    args = dict(model_parallel=mp_, pod_size=pod)
                    try:
                        want = jfault.remesh_plan(n_total, n_failed, **args)
                    except (ValueError, RuntimeError) as e:
                        with pytest.raises(type(e)):
                            remesh_plan(n_total, n_failed, **args)
                        continue
                    got = remesh_plan(n_total, n_failed, **args)
                    assert (got.shape, got.axes, got.n_chips, got.dropped_chips,
                            got.model_parallel) == (want.shape, want.axes, want.n_chips,
                                                    want.dropped_chips, want.model_parallel)
                    n += 1
    assert n > 300


# ---------------------------------------------------------------------------
# the elastic runtime
# ---------------------------------------------------------------------------

def test_local_elastic_loop_recovers_and_resumes():
    """``SpRuntime(elastic=True)`` with no group: a step that raises
    ``SpRankDeadError`` is recovered by the ``on_reshard`` hook alone, which
    may rewind; every step's last result is kept."""
    events, runs = [], []
    fail_once = {3: True}

    def step_fn(step):
        runs.append(step)
        if fail_once.pop(step, False):
            raise SpRankDeadError(f"simulated loss at step {step}")
        return step * 10

    def on_reshard(ev):
        events.append(ev)
        return ev.resume_step - 1  # rewind one step

    with SpRuntime(workers=1, elastic=True, on_reshard=on_reshard) as rt:
        out = rt.elastic_loop(step_fn, 5)
        assert rt.run_step(lambda s: s + 1, step=7) == 8
    assert out == {s: s * 10 for s in range(5)}
    assert runs == [0, 1, 2, 3, 2, 3, 4]
    assert len(events) == 1 and isinstance(events[0], ElasticEvent)
    assert (events[0].epoch, events[0].resume_step, events[0].group) == (1, 3, None)
    (rec,) = rt.recoveries
    assert (rec["mode"], rec["step"], rec["resume"]) == ("local", 3, 2)
    with pytest.raises(ValueError, match="eager"):
        SpRuntime(backend="staged", elastic=True)
    plain = SpRuntime(workers=1)
    try:
        with pytest.raises(RuntimeError, match="elastic=True"):
            plain.elastic_loop(step_fn, 1)
    finally:
        plain.stop()


def test_elastic_ring_in_process_survives_a_dead_rank():
    """Three in-process ranks under ``SpRuntime(elastic=True, group=...)``
    on one hub: rank 2 is marked dead before step 1; the survivors re-roll,
    shrink the ring and finish every step with the 2-way sums."""
    hub = ChannelHub()
    size, steps = 3, 3
    bases = [torch.full((11,), float(r + 1)) for r in range(size)]
    results: dict = {}

    def rank_main(r):
        group = SpCommGroup(r, size, hub, default_timeout=5.0, device="cpu")
        with SpRuntime(workers=2, elastic=True, group=group, detect_grace=5.0) as rt:
            def step_fn(step):
                if step == 1 and r == 2:
                    hub.mark_dead(2)
                    raise SystemExit  # the victim stops here
                x = SpData(bases[r].clone(), f"e{rt.epoch}s{step}")
                coll.ring_all_reduce(rt.graph, rt.group, x, tag=(rt.epoch, step))
                rt.barrier(timeout=30.0)
                return x.value

            try:
                results[r] = (rt.elastic_loop(step_fn, steps), rt.recoveries, rt.group.members)
            except SystemExit:
                pass

    threads = [threading.Thread(target=rank_main, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert set(results) == {0, 1}
    for r in (0, 1):
        out, recs, members = results[r]
        assert members == (0, 1) and len(recs) == 1 and recs[0]["dead"] == [2]
        assert torch.equal(out[0], torch.full((11,), 6.0))
        for step in (1, 2):
            assert torch.equal(out[step], torch.full((11,), 3.0))


def test_spawned_elastic_train_equals_the_oracle_bit_for_bit():
    """Three spawned ranks train with SGD on the CPU; the parent SIGKILLs
    rank 2 mid-step; the survivors' parameters equal
    ``elastic_train_oracle`` (the port's and ``repro``'s) bit for bit."""
    size, n, steps, lr = 3, 257, 5, 0.01
    results, info = rdv.run_elastic_train(size=size, n=n, steps=steps, fail_at=2, lr=lr,
                                          device="cpu", timeout=150.0)
    assert set(results) == {0, 1}
    resumes = {rep["resume_step"] for rep in results.values()}
    assert len(resumes) == 1 and None not in resumes
    resume = resumes.pop()
    want = rdv.elastic_train_oracle(size, n, steps, lr, resume_step=resume, dead=(info["victim"],))
    np.testing.assert_array_equal(
        want, jrdv.elastic_train_oracle(size, n, steps, lr, resume_step=resume, dead=(2,)))
    for rep in results.values():
        assert rep["recoveries"] == 1 and rep["dead"] == [2] and rep["device"] == "cpu"
        assert -0.05 < rep["detect_at"] - info["t_kill"] < 5.0
        assert rep["reroll_s"] < 30.0
        assert rep["params"].dtype == np.float32
        np.testing.assert_array_equal(rep["params"], want)


def test_runs_refuse_cuda_without_a_card():
    from repro_torch.kernels import dispatch

    if dispatch.cuda_available():
        pytest.skip("a Hopper card is present: the default device runs")
    for call in (lambda: rdv.run_ring_reduce(2), lambda: rdv.run_collective(2),
                 lambda: rdv.run_elastic_ring(3), lambda: rdv.run_elastic_train(3)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
