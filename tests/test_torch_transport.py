"""The port's cross-process wire (``repro_torch.core.comm``): SocketTransport
framing, rendezvous, lazy dial and pruning with SocketTransport ranks as
threads; the legacy RouterTransport; every wire-type code through the
scatter-gather path; collectives over sockets; and two spawned process
groups — a 2-rank ``run_ring_reduce`` and a SIGKILL of rank 0 — as
``tests/test_transport.py`` and ``tests/test_p2p.py`` hold ``repro``."""
from __future__ import annotations

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import rendezvous as jrdv  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ChannelHub,
    RouterTransport,
    SocketTransport,
    SpCommGroup,
    SpComputeEngine,
    SpData,
    SpDeserializer,
    SpSerializer,
    SpTaskGraph,
    SpWorkerTeamBuilder,
    mpi_broadcast,
    mpi_recv,
    mpi_send,
    register_wire_type,
)
from repro_torch.core.comm import _RecvRequest, decode_message, encode_segments  # noqa: E402
from repro_torch.dist.collectives import ring_all_gather, ring_all_reduce  # noqa: E402
from repro_torch.launch import rendezvous as rdv  # noqa: E402


@pytest.fixture()
def engine():
    eng = SpComputeEngine(SpWorkerTeamBuilder.team_of_cpu_workers(4))
    yield eng
    eng.stop()


def _ring(cls, size: int):
    t0 = cls(0, size)
    return [t0, *(cls(r, size, port=t0.port) for r in range(1, size))]


@pytest.fixture(params=[SocketTransport, RouterTransport], ids=["p2p", "router"])
def transport_pair(request):
    """Two transports (ranks 0, 1) in one process over localhost."""
    ts = _ring(request.param, 2)
    yield ts
    for t in reversed(ts):  # rank 0 last: its rendezvous outlives the peers
        t.close()


def _drain(tr, key, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ok, msg = tr.poll(key)
        if ok:
            return msg
        time.sleep(0.002)
    raise TimeoutError(f"nothing arrived for {key}")


# ---------------------------------------------------------------------------
# transport basics, on both transports
# ---------------------------------------------------------------------------

def test_transport_frames_keys_and_payloads(transport_pair):
    t0, t1 = transport_pair
    tag = ("rar", 3, "rs", 0)
    chunk = torch.arange(5, dtype=torch.float32)
    t0.post((0, 1, tag), {"chunk": chunk, "step": 0, "w": chunk.to(torch.bfloat16)})
    msg = _drain(t1, (0, 1, tag))
    assert torch.equal(msg["chunk"], chunk) and msg["step"] == 0
    assert msg["w"].dtype == torch.bfloat16 and torch.equal(msg["w"].float(), chunk)
    msg["chunk"] += 1  # what arrives is writable
    # wrong tag / wrong direction never match
    assert t1.poll((0, 1, ("rar", 3, "rs", 1)))[0] is False
    assert t0.poll((0, 1, tag))[0] is False


def test_transport_prunes_and_counts(transport_pair):
    t0, t1 = transport_pair
    for step in range(20):
        t0.post((0, 1, step), torch.tensor(step))
    for step in range(20):
        assert int(_drain(t1, (0, 1, step))) == step
    st = t1.stats()
    assert st["boxes"] == 0 and st["queued"] == 0
    assert st["received"] == 20 and st["delivered"] == 20
    assert t0.stats()["posted"] == 20


def test_socket_poll_is_nonblocking(transport_pair):
    _t0, t1 = transport_pair
    start = time.perf_counter()
    for _ in range(500):
        assert not t1.poll((0, 1, "never-posted"))[0]
    assert time.perf_counter() - start < 1.0  # pure dict lookups, no recv()


def test_recv_request_test_only_polls():
    """CommRequest.test() stays non-blocking: its only transport call is
    poll()."""

    class RecordingTransport:
        def __init__(self):
            self.calls = []

        def poll(self, key):
            self.calls.append(("poll", key))
            return False, None

        def __getattr__(self, name):  # any other method => contract breach
            raise AssertionError(f"request touched transport.{name}")

    tr = RecordingTransport()
    req = _RecvRequest(tr, (0, 1, "t"), ref=None, device=torch.device("cpu"))
    for _ in range(3):
        assert req.test() is False
    assert tr.calls == [("poll", (0, 1, "t"))] * 3


def test_lazy_dial_and_connection_cache():
    """Links are dialed on first use and cached; a reply reuses the
    accepted link, and self-posts never touch the wire."""
    t0, t1, t2 = _ring(SocketTransport, 3)
    try:
        assert t0.stats()["dials"] == 0 and t1.stats()["dials"] == 0
        t0.post((0, 0, "self"), 42)
        assert _drain(t0, (0, 0, "self")) == 42
        assert t0.stats()["dials"] == 0 and t0.stats()["links"] == 0
        t0.post((0, 1, "a"), torch.ones(3))
        assert torch.equal(_drain(t1, (0, 1, "a")), torch.ones(3))
        assert t0.stats()["dials"] == 1
        for i in range(5):
            t0.post((0, 1, ("a", i)), i)
        for i in range(5):
            assert _drain(t1, (0, 1, ("a", i))) == i
        assert t0.stats()["dials"] == 1
        t1.post((1, 0, "b"), 2)
        assert _drain(t0, (1, 0, "b")) == 2
        assert t1.stats()["dials"] == 0 and t1.stats()["links"] >= 1
        t0.post((0, 2, "c"), 3)
        assert _drain(t2, (0, 2, "c")) == 3
        assert t0.stats()["dials"] == 2 and t0.stats()["links"] >= 2
    finally:
        for t in (t2, t1, t0):
            t.close()


# ---------------------------------------------------------------------------
# scatter-gather frames: every wire-type code roundtrips
# ---------------------------------------------------------------------------

class _Grid:
    """``sp_serialize`` path (code ``O``)."""

    def __init__(self, values):
        self.values = values

    def sp_serialize(self, s: SpSerializer) -> None:
        s.append_array(self.values)

    @classmethod
    def sp_deserialize(cls, d: SpDeserializer) -> "_Grid":
        return cls(d.next_array())


class _Blob:
    """``comm_buffer`` path (code ``C``)."""

    def __init__(self, raw: bytes):
        self.raw = raw

    def comm_buffer(self) -> bytes:
        return self.raw

    @classmethod
    def from_comm_buffer(cls, buf: bytes) -> "_Blob":
        return cls(bytes(buf))


register_wire_type(_Grid)
register_wire_type(_Blob)


def _wire_values():
    """One value per type code: N b I J F S B T L D A W O C."""
    return {
        "N": None, "b": True, "I": -(1 << 62), "J": 1 << 80, "F": 2.5,
        "S": "naïve ∑", "B": b"\x00\xff raw", "T": (1, "two", None),
        "L": [False, 3.0, b"x"], "D": {"k": (1, 2), 7: "v"},
        "A": torch.arange(1024, dtype=torch.float32),  # 4 KiB: a memoryview segment
        "W": torch.arange(1024, dtype=torch.float32).to(torch.bfloat16),
        "O": _Grid(torch.full((3, 5), 9.0)), "C": _Blob(b"opaque-bytes"),
    }


def _same(got, want) -> bool:
    if isinstance(want, torch.Tensor):
        return got.dtype == want.dtype and torch.equal(got, want)
    if isinstance(want, _Grid):
        return isinstance(got, _Grid) and torch.equal(got.values, want.values)
    if isinstance(want, _Blob):
        return isinstance(got, _Blob) and got.raw == want.raw
    if isinstance(want, (tuple, list)):
        return type(got) is type(want) and all(_same(g, w) for g, w in zip(got, want))
    if isinstance(want, dict):
        return set(got) == set(want) and all(_same(got[k], want[k]) for k in want)
    return type(got) is type(want) and got == want


@pytest.mark.parametrize("code", sorted(_wire_values()))
def test_scatter_gather_roundtrip_per_wire_type(code):
    value = _wire_values()[code]
    segs, nbytes = encode_segments(value)
    joined = b"".join(bytes(s) for s in segs)
    assert len(joined) == nbytes and joined[:1] == code.encode()
    assert _same(decode_message(joined), value)


def test_sp_serialize_object_roundtrips_both_transports(engine):
    socks = _ring(SocketTransport, 2)
    try:
        for hub0, hub1 in ((ChannelHub(),) * 2, tuple(socks)):
            g0, g1 = SpCommGroup(0, 2, hub0), SpCommGroup(1, 2, hub1)
            tg0 = SpTaskGraph().compute_on(engine)
            tg1 = SpTaskGraph().compute_on(engine)
            r = SpData(None, "r")
            mpi_recv(tg1, g1, r, src=0, tag="grid", timeout=30.0)
            mpi_send(tg0, g0, SpData(_Grid(torch.full((2, 3), 7.0)), "m"), dest=1, tag="grid")
            tg0.wait_all_tasks()
            tg1.wait_all_tasks()
            assert isinstance(r.value, _Grid)
            r.value.values += 1.0  # received tensors are writable in place
            assert torch.equal(r.value.values, torch.full((2, 3), 8.0))
    finally:
        for t in reversed(socks):
            t.close()


# ---------------------------------------------------------------------------
# collectives over sockets (ranks as threads in one process)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("cls", [SocketTransport, RouterTransport], ids=["p2p", "router"])
def test_ring_all_reduce_socket_threads(engine, op, cls):
    """17 elements over 3 ranks: uneven chunks on the wire; every rank's
    result equals the NumPy replay of the ring's order bit for bit."""
    size = 3
    transports = _ring(cls, size)
    try:
        rng = np.random.default_rng(7)
        arrays = [rng.standard_normal(17).astype(np.float32) for _ in range(size)]
        groups = [SpCommGroup(r, size, transports[r], default_timeout=60.0, device="cpu")
                  for r in range(size)]
        graphs = [SpTaskGraph().compute_on(engine) for _ in range(size)]
        cells = [SpData(torch.from_numpy(arrays[r].copy()), f"s{r}") for r in range(size)]
        for r in range(size):
            ring_all_reduce(graphs[r], groups[r], cells[r], op=op)
        for g in graphs:
            g.wait_all_tasks()
        expected = rdv.ring_order_sum(arrays)
        if op == "mean":
            expected = expected / np.float32(size)
        for r in range(size):
            assert cells[r].value.dtype == torch.float32
            np.testing.assert_array_equal(cells[r].value.numpy(), expected)
        for t in transports:
            assert t.stats()["boxes"] == 0
    finally:
        for t in reversed(transports):
            t.close()


def test_ring_all_gather_and_broadcast_socket_threads(engine):
    size = 2
    transports = _ring(SocketTransport, size)
    try:
        groups = [SpCommGroup(r, size, transports[r], default_timeout=60.0) for r in range(size)]
        graphs = [SpTaskGraph().compute_on(engine) for _ in range(size)]
        cells = [SpData(torch.arange(4) + 10 * r, f"x{r}") for r in range(size)]
        views = [ring_all_gather(graphs[r], groups[r], cells[r]) for r in range(size)]
        bcells = [SpData(torch.linspace(0, 1, 5) if r == 0 else None, f"b{r}") for r in range(size)]
        for r in range(size):
            mpi_broadcast(graphs[r], groups[r], bcells[r], root=0)
        for g in graphs:
            g.wait_all_tasks()
        for r in range(size):
            got = views[r].get_value()
            assert [g.tolist() for g in got] == [list(range(10 * s, 10 * s + 4)) for s in range(size)]
            assert torch.equal(bcells[r].value, torch.linspace(0, 1, 5))
    finally:
        for t in reversed(transports):
            t.close()


def test_ring_order_oracle_matches_repros_two_rank_sum():
    """At two ranks every element is one float32 addition: the port's
    ring-order oracle equals ``repro``'s plain reference there."""
    arrays = [np.random.default_rng(r).standard_normal(4099).astype(np.float32) for r in range(2)]
    np.testing.assert_array_equal(rdv.ring_order_sum(arrays), arrays[0] + arrays[1])
    np.testing.assert_array_equal(rdv._det_grad(1, 2, 4099), jrdv._det_grad(1, 2, 4099))


# ---------------------------------------------------------------------------
# spawned process groups
# ---------------------------------------------------------------------------

def test_two_process_ring_all_reduce_over_tcp():
    """Two spawned processes reduce float32[4099] (odd: non-divisible
    chunks) on the CPU over the socket transport: the sum equals the NumPy
    reference bit for bit (one addition an element), the mean equals it
    divided by 2 in float32, and both ranks agree."""
    size, n = 2, 4099
    results = rdv.run_ring_reduce(size, n, steps=2, timeout=120.0, device="cpu")
    arrays = [np.random.default_rng(r).standard_normal(n).astype(np.float32) for r in range(size)]
    expected = arrays[0] + arrays[1]
    for rank in range(size):
        rep = results[rank]
        assert rep["device"] == "cpu" and rep["sum"].dtype == np.float32
        np.testing.assert_array_equal(rep["sum"], expected)
        np.testing.assert_array_equal(rep["mean"], expected / np.float32(size))
        assert len(rep["walls"]) == 2 and rep["d2h_s"] >= 0.0
        st = rep["stats"]
        assert st["boxes"] == 0 and st["queued"] == 0
        assert st["received"] == st["delivered"] > 0


def test_sigkill_rank0_detected_without_router():
    """SIGKILL rank 0 — the rendezvous rank itself — mid-collective: the
    survivors detect the death over their direct links, re-mesh, and
    finish; the shrunken steps' 2-way sums are bit-exact."""
    n, steps = 257, 4
    results, info = rdv.run_elastic_ring(size=3, n=n, steps=steps, fail_at=2, victim=0,
                                         device="cpu", timeout=150.0)
    assert info["victim"] == 0 and set(results) == {1, 2}
    bases = [np.random.default_rng(r).standard_normal(n).astype(np.float32) for r in range(3)]
    full = rdv.ring_order_sum(bases)
    resumes = {rep["resume_step"] for rep in results.values()}
    assert len(resumes) == 1
    resume = resumes.pop()
    assert resume is not None and 0 <= resume < steps
    for rank, rep in results.items():
        assert rep["dead"] == [0] and rep["members"] == [1, 2] and rep["device"] == "cpu"
        latency = rep["detect_at"] - info["t_kill"]
        assert -0.05 < latency < 5.0, f"rank {rank}: detection took {latency}s"
        assert sorted(rep["steps"]) == list(range(steps))
        for step, arr in rep["steps"].items():
            # full-mesh steps: the 3-way ring order; shrunken: 2-way sums
            np.testing.assert_array_equal(arr, full if step < resume else bases[1] + bases[2])
