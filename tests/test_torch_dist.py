"""The port's ring collectives (``repro_torch.dist.collectives``) against
``repro``'s, bit for bit, over a ``ChannelHub``: ``ring_all_reduce`` (sum
and mean, 1–4 ranks, with and without chunk pipelining, an int32 mean, a
group shrunk after a death), ``ring_all_gather`` and
``hierarchical_all_reduce``; the ``axis=`` spelling raises."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.dist.collectives as jcoll  # noqa: E402
import repro_torch.core as core  # noqa: E402
import repro_torch.dist.collectives as coll  # noqa: E402


def _run(pkg, collective, values, members=None, **kw):
    """Each rank's result of ``collective`` over one hub: ``pkg`` is
    (core module, collectives module); ``values`` one input per rank (in
    logical order when ``members`` is given)."""
    cm, dm = pkg
    size = len(values) if members is None else max(members) + 1
    members = list(range(len(values))) if members is None else members
    eng = cm.SpComputeEngine(cm.SpWorkerTeamBuilder.team_of_cpu_workers(4))
    try:
        hub = cm.ChannelHub()
        full = [cm.SpCommGroup(r, size, hub, default_timeout=30.0) for r in members]
        groups = [g.shrunk([r for r in range(size) if r not in members]) for g in full]
        graphs = [cm.SpTaskGraph().compute_on(eng) for _ in members]
        cells = [cm.SpData(v, f"x{r}") for r, v in zip(members, values)]
        views = [getattr(dm, collective)(tg, g, c, **kw) for tg, g, c in zip(graphs, groups, cells)]
        for tg in graphs:
            tg.wait_all_tasks()
        assert hub.stats()["boxes"] == 0  # every mailbox drained and pruned
        return [v.get_value() for v in views]
    finally:
        eng.stop()


PORT, REPRO = (core, coll), (jcore, jcoll)


def _inputs(size, n, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "i":
        return [rng.integers(-1000, 1000, n).astype(dtype) for _ in range(size)]
    return [rng.standard_normal(n).astype(dtype) for _ in range(size)]


def _same(got, want):
    """A port tensor equals a repro array: dtype, shape and every bit."""
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("size", [1, 2, 3, 4])
@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("chunk_bytes", [None, 64])
def test_ring_all_reduce_equals_repro_bit_for_bit(size, op, chunk_bytes):
    """257 float32 (no rank count divides it): the chunk boundaries and the
    order of every addition are ``repro``'s, so every bit is; 64-byte
    pieces pipeline each rank-chunk into several frames."""
    xs = _inputs(size, 257, seed=size)
    want = _run(REPRO, "ring_all_reduce", [x.copy() for x in xs], op=op, chunk_bytes=chunk_bytes)
    got = _run(PORT, "ring_all_reduce", [torch.from_numpy(x.copy()) for x in xs], op=op,
               chunk_bytes=chunk_bytes)
    for g, w in zip(got, want):
        _same(g, w)


def test_ring_all_reduce_2d_and_int32_mean_equal_repro():
    """A (5, 7) float32 input keeps its shape; an int32 mean divides in
    float64 and truncates back, as numpy's promotion does in ``repro``."""
    xs = [x.reshape(5, 7) for x in _inputs(3, 35, seed=9)]
    for g, w in zip(_run(PORT, "ring_all_reduce", [torch.from_numpy(x) for x in xs], op="mean"),
                    _run(REPRO, "ring_all_reduce", xs, op="mean")):
        _same(g, w)
    ints = _inputs(3, 50, np.int32, seed=3)
    got = _run(PORT, "ring_all_reduce", [torch.from_numpy(x) for x in ints], op="mean")
    want = _run(REPRO, "ring_all_reduce", ints, op="mean")
    assert (np.sum(ints, axis=0) % 3 != 0).any()  # the division truncates somewhere
    for g, w in zip(got, want):
        _same(g, w)


def test_ring_all_reduce_on_shrunken_group_equals_repro():
    """Ranks {0, 1, 3} of 4 after rank 2 died: the ring runs in logical
    coordinates over the survivors."""
    xs = _inputs(3, 101, seed=5)
    got = _run(PORT, "ring_all_reduce", [torch.from_numpy(x) for x in xs], members=[0, 1, 3])
    want = _run(REPRO, "ring_all_reduce", xs, members=[0, 1, 3])
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("size", [1, 3])
def test_ring_all_gather_orders_by_rank_as_repro(size):
    xs = [np.arange(4, dtype=np.float32) + 10 * r for r in range(size)]
    got = _run(PORT, "ring_all_gather", [torch.from_numpy(x) for x in xs])
    want = _run(REPRO, "ring_all_gather", xs)
    for g, w in zip(got, want):
        assert len(g) == len(w) == size
        for gi, wi in zip(g, w):
            _same(gi, wi)


@pytest.mark.parametrize("size,pod_size", [(4, 2), (4, 4), (6, 3), (4, 1)])
@pytest.mark.parametrize("op", ["sum", "mean"])
def test_hierarchical_all_reduce_equals_repro(size, pod_size, op):
    xs = _inputs(size, 97, seed=size + pod_size)
    got = _run(PORT, "hierarchical_all_reduce", [torch.from_numpy(x) for x in xs],
               pod_size=pod_size, op=op)
    want = _run(REPRO, "hierarchical_all_reduce", xs, pod_size=pod_size, op=op)
    for g, w in zip(got, want):
        _same(g, w)


def test_hub_stays_bounded_over_a_100_step_ring_loop():
    eng = core.SpComputeEngine(core.SpWorkerTeamBuilder.team_of_cpu_workers(2))
    try:
        hub = core.ChannelHub()
        groups = [core.SpCommGroup(r, 2, hub) for r in range(2)]
        tgs = [core.SpTaskGraph(trace=False).compute_on(eng) for _ in range(2)]
        for step in range(100):
            cells = [core.SpData(torch.full((8,), float(r + step)), f"c{r}") for r in range(2)]
            for r in range(2):
                coll.ring_all_reduce(tgs[r], groups[r], cells[r], tag=step)
            for tg in tgs:
                tg.wait_all_tasks()
            assert float(cells[0].value[0]) == 2 * step + 1
        assert hub.stats()["boxes"] == 0 and hub.stats()["queued"] == 0
    finally:
        eng.stop()


def test_sent_chunks_are_never_written_in_place():
    """Over the hub the receiver aliases the sender's tensors, so the ring
    must allocate every sum: the input tensor itself is left as it was
    (``x.value`` is rebound to a new tensor)."""
    xs = [torch.arange(6, dtype=torch.float32) + r for r in range(3)]
    before = [x.clone() for x in xs]
    got = _run(PORT, "ring_all_reduce", xs)
    for x, b, g in zip(xs, before, got):
        assert torch.equal(x, b) and g.data_ptr() != x.data_ptr()


def test_substrate_spellings():
    """``all_reduce`` / ``all_gather`` with ``graph=``/``group=`` are the
    rings; the ``axis=`` spelling and ``hierarchical_psum`` need a device
    mesh the port does not have yet, and say so."""
    xs = [torch.ones(3) * (r + 1) for r in range(2)]
    eng = core.SpComputeEngine(core.SpWorkerTeamBuilder.team_of_cpu_workers(2))
    try:
        hub = core.ChannelHub()
        groups = [core.SpCommGroup(r, 2, hub) for r in range(2)]
        tgs = [core.SpTaskGraph().compute_on(eng) for _ in range(2)]
        cells = [core.SpData(x, f"x{r}") for r, x in enumerate(xs)]
        views = [coll.all_reduce(c, graph=tg, group=g) for c, tg, g in zip(cells, tgs, groups)]
        gathers = [coll.all_gather(core.SpData(x, "y"), graph=tg, group=g)
                   for x, tg, g in zip(xs, tgs, groups)]
        for tg in tgs:
            tg.wait_all_tasks()
        assert all(torch.equal(v.get_value(), torch.full((3,), 3.0)) for v in views)
        assert all(len(v.get_value()) == 2 for v in gathers)
    finally:
        eng.stop()
    for fn in (coll.all_reduce, coll.all_gather):
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            fn(xs[0], axis="data")
        with pytest.raises(ValueError, match="group"):
            fn(xs[0])
    with pytest.raises(NotImplementedError, match="device mesh"):
        coll.hierarchical_psum(xs[0])
