"""The port's schedulers and staged linearization against ``repro``'s.

Every case of ``tests/test_schedulers.py`` runs as a parity case: the same
scenario is built in ``repro.core`` and in ``repro_torch.core`` (the port's
copy of the runtime), and the two give the same pop orders, counters,
linearizations (by task name), ``schedule_summary``, upward ranks and staged
results, which also meet the reference test's own expectations.
"""
from __future__ import annotations

import importlib

import pytest
from hypothesis import given, settings, strategies as st

PACKAGES = ("repro", "repro_torch")


def _pkg(name: str):
    """(core, task module, access module) of a package."""
    return tuple(importlib.import_module(f"{name}.core{sub}") for sub in ("", ".task", ".access"))


def _both(scenario, *args):
    """The scenario's result in each package; they must be equal."""
    ref, port = (scenario(*_pkg(name), *args) for name in PACKAGES)
    assert port == ref
    return port


def _mk_task(core, task_mod, access_mod, name, prio=0, cost=1.0):
    x = core.SpData(0, name + ".x")
    acc = access_mod.SpAccess(x, core.AccessMode.READ)
    t = task_mod.Task({"ref": lambda v: None}, [acc], [("single", acc)], priority=prio, name=name, cost=cost)
    t.state = "ready"
    return t


def test_fifo_lifo_priority_order():
    def scenario(core, task_mod, access_mod):
        out = []
        for s in (core.FifoScheduler(), core.LifoScheduler(), core.PriorityScheduler()):
            for i in range(3):
                s.push(_mk_task(core, task_mod, access_mod, f"t{i}", prio=i))
            out.append([s.pop().name for _ in range(3)] + [s.pop()])
        return out

    assert _both(scenario) == [["t0", "t1", "t2", None], ["t2", "t1", "t0", None], ["t2", "t1", "t0", None]]


def test_work_stealing():
    def scenario(core, task_mod, access_mod):
        ws = core.WorkStealingScheduler()
        for i in range(4):
            ws.push(_mk_task(core, task_mod, access_mod, f"t{i}"))
        return sorted(ws.pop(worker_name="w0").name for _ in range(4))

    assert _both(scenario) == ["t0", "t1", "t2", "t3"]


def test_locality_push_lands_on_last_writer_deque():
    def scenario(core, task_mod, access_mod):
        ws = core.WorkStealingScheduler(locality=True)
        ws.register_worker("wa")
        ws.register_worker("wb")
        hinted = _mk_task(core, task_mod, access_mod, "t0")
        hinted.accesses[0].data.last_writer = "wb"
        owner = ws.push(hinted)
        hits = ws.stats()["locality_hits"]
        t = ws.pop(worker_name="wb")
        s = ws.stats()
        stray = _mk_task(core, task_mod, access_mod, "t1")
        stray.accesses[0].data.last_writer = "nonexistent-worker"
        owner2 = ws.push(stray)
        return owner, hits, t.name, s["pops_local"], s["steals"], owner2 in ("wa", "wb"), ws.stats()["locality_hits"]

    assert _both(scenario) == ("wb", 1, "t0", 1, 0, True, 1)


def test_dominant_input_wins_locality_vote():
    def scenario(core, task_mod, access_mod):
        ws = core.WorkStealingScheduler(locality=True)
        ws.register_worker("wa")
        ws.register_worker("wb")
        xs = [core.SpData(0, f"x{i}") for i in range(3)]
        for x, w in zip(xs, ("wa", "wb", "wb")):
            x.last_writer = w
        accs = [access_mod.SpAccess(x, core.AccessMode.READ) for x in xs]
        return ws.push(task_mod.Task({"ref": lambda *a: None}, accs, [("single", a) for a in accs], name="multi"))

    assert _both(scenario) == "wb"


def test_steal_counters_increment():
    def scenario(core, task_mod, access_mod):
        ws = core.WorkStealingScheduler(locality=False)
        ws.register_worker("wa")
        ws.register_worker("wb")
        for i in range(4):
            ws.push(_mk_task(core, task_mod, access_mod, f"t{i}"))
        ws.register_worker("wc")
        got = 0
        while ws.pop(worker_name="wc") is not None:
            got += 1
        s = ws.stats()
        return got, s["steals"], s["pops_local"], s["failed_pops"] >= 1, s["steal_rate"]

    assert _both(scenario) == (4, 4, 0, True, 1.0)


def test_overflow_preferred_over_stealing():
    def scenario(core, task_mod, access_mod):
        ws = core.WorkStealingScheduler(locality=False)
        ws.push(_mk_task(core, task_mod, access_mod, "orphan"))
        ws.register_worker("wa")
        ws.register_worker("wb")
        ws.push(_mk_task(core, task_mod, access_mod, "r0"))
        ws.push(_mk_task(core, task_mod, access_mod, "r1"))
        first = ws.pop(worker_name="wc-idle").name
        rest = sorted(ws.pop(worker_name="wc-idle").name for _ in range(2))
        return first, rest, ws.stats()["pops_overflow"]

    assert _both(scenario) == ("orphan", ["r0", "r1"], 1)


def test_unregister_drains_to_overflow_and_gets_popped():
    def scenario(core, task_mod, access_mod):
        ws = core.WorkStealingScheduler(locality=False)
        ws.register_worker("wa")
        ws.register_worker("wb")
        for i in range(4):
            ws.push(_mk_task(core, task_mod, access_mod, f"t{i}"))
        n_wa = len(ws._deques["wa"].q)
        ws.unregister_worker("wa")
        names = []
        while (t := ws.pop(worker_name="wb")) is not None:
            names.append(t.name)
        return "wa" in ws._deques, sorted(names), ws.stats()["pops_overflow"] == n_wa or not n_wa

    assert _both(scenario) == (False, ["t0", "t1", "t2", "t3"], True)


def test_priority_len_is_thread_safe_under_lock():
    def scenario(core, task_mod, access_mod):
        p = core.PriorityScheduler()
        n0 = len(p)
        p.push(_mk_task(core, task_mod, access_mod, "t", prio=3))
        return n0, len(p)

    assert _both(scenario) == (0, 1)


def test_make_scheduler_registry():
    def scenario(core, task_mod, access_mod):
        kinds = [type(core.make_scheduler(n)).__name__
                 for n in ("fifo", "lifo", "priority", "critical_path", "work_stealing")]
        with pytest.raises(ValueError):
            core.make_scheduler("nope")
        return kinds

    assert len(_both(scenario)) == 5


def _random_graph(core, seed_modes):
    tg = core.SpTaskGraph()
    cells = [core.SpData(0, f"c{i}") for i in range(3)]
    for i, (ci, mode_w) in enumerate(seed_modes):
        acc = core.SpWrite(cells[ci]) if mode_w else core.SpRead(cells[ci])
        tg.task(acc, lambda *_: None, name=f"t{i}", priority=i % 3)
    return tg


@settings(max_examples=15, deadline=None)
@given(
    seed_modes=st.lists(st.tuples(st.integers(0, 2), st.booleans()), min_size=1, max_size=12),
    policy=st.sampled_from(["fifo", "priority", "critical_path", "overlap"]),
)
def test_property_linearize_is_topological(seed_modes, policy):
    """Every policy gives the same linearization (by task name) in both
    packages, and it is a topological order of the STF edges."""
    def scenario(core, task_mod, access_mod):
        tg = _random_graph(core, seed_modes)
        order = core.linearize(tg, policy)
        pos = {t.uid: i for i, t in enumerate(order)}
        assert all(pos[src.uid] < pos[dst.uid] for src, dst in tg.edges())
        return [t.name for t in order], core.schedule_summary(order)

    names, summary = _both(scenario)
    assert sorted(names) == sorted(f"t{i}" for i in range(len(seed_modes)))
    assert summary["n_tasks"] == len(seed_modes) and summary["n_comm"] == 0


def test_overlap_hoists_comm():
    def scenario(core, task_mod, access_mod):
        tg = core.SpTaskGraph()
        xs = [core.SpData(0, f"x{i}") for i in range(3)]
        for i in range(3):
            tg.task(core.SpWrite(xs[i]), lambda r: None, name=f"compute{i}")
        tg.task(core.SpRead(xs[0]), lambda v: None, name="allreduce", comm=True)
        orders = {p: core.linearize(tg, p) for p in ("fifo", "priority", "critical_path", "overlap")}
        return {p: ([t.name for t in o], core.schedule_summary(o)) for p, o in orders.items()}

    out = _both(scenario)
    fifo, overlap = out["fifo"][0], out["overlap"][0]
    assert overlap.index("allreduce") < fifo.index("allreduce")
    for names, summary in out.values():
        assert summary["n_comm"] == 1 and summary["comm_positions"] == [names.index("allreduce")]


def test_critical_path_ranks():
    def scenario(core, task_mod, access_mod):
        tg = core.SpTaskGraph()
        a, b = core.SpData(0, "a"), core.SpData(0, "b")
        tg.task(core.SpWrite(a), lambda r: None, name="head", cost=1.0)
        tg.task(core.SpRead(a), lambda v: None, name="long", cost=10.0)
        tg.task(core.SpWrite(b), lambda r: None, name="solo", cost=1.0)
        core.compute_upward_ranks(tg.tasks, tg.successor_map())
        return {t.name: t._rank for t in tg.tasks}

    ranks = _both(scenario)
    assert ranks["head"] > ranks["solo"]


@pytest.mark.parametrize("policy", ["fifo", "priority", "critical_path", "overlap"])
def test_execute_staged_respects_values(policy):
    def scenario(core, task_mod, access_mod):
        tg = core.SpTaskGraph()
        x, y = core.SpData(2.0, "x"), core.SpData(0.0, "y")
        tg.task(core.SpRead(x), core.SpWrite(y), lambda v, r: setattr(r, "value", v + 1), name="add")
        tg.task(core.SpWrite(y), lambda r: setattr(r, "value", r.value * 10), name="scale")
        order = core.execute_staged(tg, policy)
        return y.value, [t.name for t in order], core.schedule_summary(order)

    value, names, summary = _both(scenario)
    assert value == 30.0 and names == ["add", "scale"] and summary["n_tasks"] == 2


def test_execute_staged_propagates_the_first_error_and_cancels_the_rest():
    def scenario(core, task_mod, access_mod):
        tg = core.SpTaskGraph()
        x = core.SpData(1.0, "x")

        def boom(r):
            raise RuntimeError("task failed")

        tg.task(core.SpWrite(x), boom, name="boom")
        tail = tg.task(core.SpWrite(x), lambda r: setattr(r, "value", 5.0), name="tail")
        with pytest.raises(RuntimeError, match="task failed"):
            core.execute_staged(tg, "fifo")
        return x.value, tail.task.state

    assert _both(scenario) == (1.0, "cancelled")


def test_runtime_schedule_is_the_staged_order_of_the_last_run():
    """``SpRuntime.schedule``: the order of the last staged run (the comm
    task hoisted right after the write it reads, under ``overlap``)."""
    def scenario(core, task_mod, access_mod):
        with core.SpRuntime(backend="staged", policy="overlap") as rt:
            xs = [core.SpData(0, f"x{i}") for i in range(3)]
            for i in range(3):
                rt.task(core.SpWrite(xs[i]), lambda r: setattr(r, "value", r.value + 1), name=f"compute{i}")
            rt.task(core.SpRead(xs[0]), lambda v: None, name="allreduce", comm=True)
            assert rt.schedule == []
            order = rt.run()
            return [t.name for t in rt.schedule], [t.name for t in order], [x.value for x in xs]

    schedule, order, values = _both(scenario)
    assert schedule == order == ["compute0", "allreduce", "compute1", "compute2"]
    assert values == [1, 1, 1]
