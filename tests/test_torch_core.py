"""The port's copy of the runtime (``repro_torch.core``) against ``repro.core``.

The same graphs are built in both packages and give the same results: the
STF property over random task streams of the paper's access modes (Read,
Write, Commutative, Atomic, MaybeWrite) on worker engines, the sequential
result included; speculation models 1 and 2 committing and rolling back to
the same values; ``SpPriority`` order on one worker; ``generate_dot`` text;
the public names (``__all__``), with the one renamed entry and the one
renamed worker kind stated here.
"""
from __future__ import annotations

import importlib
import re
import threading

import pytest
from hypothesis import given, settings, strategies as st

import repro.core as jcore
import repro_torch.core as tcore

PACKAGES = {"repro": jcore, "repro_torch": tcore}
# the one name of repro.core.__all__ the port renames, and its device
# implementation kind: "pallas" (the TPU kernels) is "cuda" in the port
RENAMED = {"SpPallas": "SpCuda"}
RENAMED_KINDS = {"pallas": "cuda"}


def test_the_reference_names_resolve_in_the_port():
    missing = [n for n in jcore.__all__ if n not in tcore.__all__ or not hasattr(tcore, n)]
    assert missing == list(RENAMED)
    for old, new in RENAMED.items():
        assert hasattr(tcore, new) and not hasattr(tcore, old)
    # the paper's spellings of the device-kernel path
    for core, kind in ((jcore, "pallas"), (tcore, "cuda")):
        assert core.SpHip(lambda: None).kind == core.SpCuda(lambda: None).kind == kind
        assert core.SpCpu(lambda: None).kind == "ref"


def test_the_worker_kind_rename():
    jteam = jcore.SpWorkerTeamBuilder.team_of_cpu_cuda_workers(2, 1)
    tteam = tcore.SpWorkerTeamBuilder.team_of_cpu_cuda_workers(2, 1)
    assert [RENAMED_KINDS.get(k, k) for k in jteam.kinds] == tteam.kinds == ["ref", "ref", "cuda"]


# ---------------------------------------------------------------------------
# the STF property
# ---------------------------------------------------------------------------

MODES = ("read", "write", "commutative", "atomic", "maybe")
task_strategy = st.lists(
    st.tuples(
        st.lists(st.tuples(st.integers(0, 3), st.sampled_from(MODES)), min_size=1, max_size=3,
                 unique_by=lambda t: t[0]),
        st.integers(1, 5),  # the body's multiplier
        st.booleans(),      # whether a maybe-writer writes
    ),
    min_size=1,
    max_size=12,
)


def _sequential_oracle(stream):
    cells = [0, 10, 20, 30]
    for accesses, mult, writes in stream:
        read_sum = sum(cells[i] for i, m in accesses if m == "read")
        for i, m in accesses:
            if m != "read" and (m != "maybe" or writes):
                cells[i] = cells[i] + mult + read_sum
    return cells


def _run_stream(core, stream, n_workers):
    """The stream on an engine of ``n_workers``; every writer adds ``mult``
    and the sum of what it read (commutative), atomic writers under the
    user's lock (their contract), a maybe-writer only when it writes; every
    body rebinds its write refs."""
    wrap = {"read": core.SpRead, "write": core.SpWrite, "commutative": core.SpCommutativeWrite,
            "atomic": core.SpAtomicWrite, "maybe": core.SpMaybeWrite}
    lock = threading.Lock()
    eng = core.SpComputeEngine(core.SpWorkerTeamBuilder.team_of_cpu_workers(n_workers))
    try:
        tg = core.SpTaskGraph()
        cells = [core.SpData(v, f"c{i}") for i, v in enumerate([0, 10, 20, 30])]

        def make_body(accesses, mult, writes):
            modes = [m for _, m in accesses]

            def body(*args):
                read_sum = sum(a for a, m in zip(args, modes) if m == "read")
                with lock if "atomic" in modes else _nothing():
                    for a, m in zip(args, modes):
                        if m != "read" and (m != "maybe" or writes):
                            a.value = a.value + mult + read_sum

            return body

        for accesses, mult, writes in stream:
            tg.task(*[wrap[m](cells[i]) for i, m in accesses], make_body(accesses, mult, writes))
        tg.compute_on(eng)
        tg.wait_all_tasks()
        return [c.value for c in cells]
    finally:
        eng.stop()


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@settings(max_examples=12, deadline=None)
@given(stream=task_strategy, n_workers=st.sampled_from([1, 3]))
def test_property_parallel_equals_sequential_in_both_runtimes(stream, n_workers):
    want = _sequential_oracle(stream)
    assert _run_stream(tcore, stream, n_workers) == _run_stream(jcore, stream, n_workers) == want


# ---------------------------------------------------------------------------
# speculation
# ---------------------------------------------------------------------------

def _spec_chain(core, model, writes, engine):
    """Maybe-writers of x, each followed (model 1) or the chain followed
    (model 2) by a reader of x writing y; bodies rebind their refs."""
    tg = core.SpTaskGraph(model).compute_on(engine)
    x, y = core.SpData(1.0, "x"), core.SpData(0.0, "y")
    for i, do_write in enumerate(writes):
        def update(ref, _w=do_write):
            if _w:
                ref.value = ref.value + 10.0

        tg.task(core.SpMaybeWrite(x), update, name=f"u{i}")
        if model != core.SpSpeculativeModel.SP_MODEL_2:
            tg.task(core.SpRead(x), core.SpWrite(y), lambda xv, yref: setattr(yref, "value", yref.value + xv),
                    name=f"r{i}")
    if model == core.SpSpeculativeModel.SP_MODEL_2:
        tg.task(core.SpRead(x), core.SpWrite(y), lambda xv, yref: setattr(yref, "value", xv * 2), name="r")
    tg.wait_all_tasks()
    return x.value, y.value, dict(tg.spec_stats)


@pytest.fixture(scope="module")
def engines():
    out = {name: core.SpComputeEngine(core.SpWorkerTeamBuilder.team_of_cpu_workers(4))
           for name, core in PACKAGES.items()}
    yield out
    for eng in out.values():
        eng.stop()


@pytest.mark.parametrize("model", ["SP_MODEL_1", "SP_MODEL_2"])
@pytest.mark.parametrize("writes", [[False], [True], [False, True, False], [True, True], [False, False, False]],
                         ids=str)
def test_speculation_commits_and_rolls_back_to_the_same_values(engines, model, writes):
    got = {name: _spec_chain(core, getattr(core.SpSpeculativeModel, model), writes, engines[name])
           for name, core in PACKAGES.items()}
    assert got["repro_torch"][:2] == got["repro"][:2]
    plain = _spec_chain(tcore, tcore.SpSpeculativeModel.SP_NO_SPEC, writes, engines["repro_torch"])
    # without speculation model 2's chain is model 1's chain without the interleaved readers
    if model == "SP_MODEL_1":
        assert got["repro_torch"][:2] == plain[:2]
    stats_t, stats_j = got["repro_torch"][2], got["repro"][2]
    assert stats_t["commits"] + stats_t["rollbacks"] == stats_j["commits"] + stats_j["rollbacks"]
    if model == "SP_MODEL_1":
        assert (stats_t["commits"], stats_t["rollbacks"]) == (writes.count(False), writes.count(True))


# ---------------------------------------------------------------------------
# SpPriority order, generate_dot
# ---------------------------------------------------------------------------

def test_priority_order_on_one_worker():
    """Eight ready tasks of random priorities on one worker under the
    priority scheduler run in the same order in both runtimes: priority
    first, insertion order among equals."""
    prios = [3, 1, 4, 1, 5, 9, 2, 6]
    orders = {}
    for name, core in PACKAGES.items():
        eng = core.SpComputeEngine(core.SpWorkerTeamBuilder.team_of_cpu_workers(1), core.PriorityScheduler())
        try:
            tg = core.SpTaskGraph()
            ran = []
            for i, p in enumerate(prios):
                tg.task(core.SpPriority(p), core.SpWrite(core.SpData(0, f"c{i}")),
                        lambda r, _i=i: ran.append(_i), name=f"t{i}")
            tg.compute_on(eng)
            tg.wait_all_tasks()
            orders[name] = ran
        finally:
            eng.stop()
    assert orders["repro_torch"] == orders["repro"] == sorted(range(8), key=lambda i: (-prios[i], i))


def _dot(core, tmp_path, show_accesses):
    tg = core.SpTaskGraph()
    a, b, c = (core.SpData(0, n) for n in "abc")
    tg.task(core.SpWrite(a), lambda r: None, name="init")
    tg.task(core.SpRead(a), core.SpCommutativeWrite(b), lambda v, r: None, name="acc0")
    tg.task(core.SpRead(a), core.SpCommutativeWrite(b), lambda v, r: None, name="acc1")
    tg.task(core.SpRead(b), core.SpMaybeWrite(c), lambda v, r: None, name="maybe")
    tg.task(core.SpRead(c), lambda v: None, name="send", comm=True)
    text = tg.generate_dot(str(tmp_path / f"{core.__name__}.dot"), show_accesses=show_accesses)
    index = {f"t{t.uid}": f"t{i}" for i, t in enumerate(tg.tasks)}  # uids count per process
    return re.sub(r"\bt\d+\b", lambda m: index[m.group(0)], text)


@pytest.mark.parametrize("show_accesses", [False, True])
def test_generate_dot_text_is_the_same(tmp_path, show_accesses):
    want = _dot(jcore, tmp_path, show_accesses)
    assert _dot(tcore, tmp_path, show_accesses) == want
    assert want.count("->") >= 4


@pytest.mark.parametrize("policy", ["fifo", "priority", "critical_path", "overlap"])
def test_staged_runtime_linearizes_the_same(policy):
    """The staged ``SpRuntime`` on a graph with priorities, costs and a comm
    task: the same schedule by name (``SpRuntime.schedule``), the same
    ``schedule_summary`` and the same values."""
    out = {}
    for name, core in PACKAGES.items():
        mod = importlib.import_module(f"{name}.core.staged")
        with core.SpRuntime(backend="staged", policy=policy) as rt:
            xs = [core.SpData(1, f"x{i}") for i in range(4)]
            for i in range(4):
                rt.task(core.SpPriority(i % 3), core.SpWrite(xs[i]), lambda r, _i=i: setattr(r, "value", r.value + _i),
                        name=f"w{i}", cost=1.0 + i)
            rt.task(core.SpRead(xs[1]), core.SpWrite(xs[2]), lambda v, r: setattr(r, "value", r.value * v),
                    name="mix", cost=5.0)
            rt.task(core.SpRead(xs[3]), lambda v: None, name="send", comm=True)
            rt.run()
            out[name] = ([t.name for t in rt.schedule], mod.schedule_summary(rt.schedule), [x.value for x in xs])
    assert out["repro_torch"] == out["repro"]
