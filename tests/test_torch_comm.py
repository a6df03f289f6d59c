"""The port's communication tasks and comm thread (``repro_torch.core.comm``)
with torch payloads: the 17 cases of ``tests/test_comm.py``, the wire codec
against ``repro``'s byte for byte, bf16 and writable decoding, and a
group's ``device=``."""
from __future__ import annotations

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import comm as jcomm  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ChannelHub,
    SpCommAbortedError,
    SpCommGroup,
    SpCommTimeoutError,
    SpComputeEngine,
    SpData,
    SpDeserializer,
    SpRead,
    SpSerializer,
    SpTaskGraph,
    SpWorkerTeamBuilder,
    SpWrite,
    decode_message,
    default_hub,
    encode_message,
    mpi_broadcast,
    mpi_recv,
    mpi_send,
    reset_default_hub,
)
from repro_torch.core.comm import encode_segments  # noqa: E402


@pytest.fixture()
def engine():
    eng = SpComputeEngine(SpWorkerTeamBuilder.team_of_cpu_workers(2))
    yield eng
    eng.stop()


def _pair(engine, hub=None, **kw):
    hub = hub if hub is not None else ChannelHub()
    groups = SpCommGroup(0, 2, hub, **kw), SpCommGroup(1, 2, hub, **kw)
    graphs = SpTaskGraph().compute_on(engine), SpTaskGraph().compute_on(engine)
    return groups, graphs


def test_send_recv_releases_dependencies(engine):
    (g0, g1), (tg0, tg1) = _pair(engine)
    m = SpData(torch.arange(6, dtype=torch.float32), "m")
    r, got = SpData(None, "r"), SpData(None, "got")
    mpi_recv(tg1, g1, r, src=0, tag=3)
    # downstream compute on the received value must wait for the recv
    tg1.task(SpRead(r), SpWrite(got), lambda v, ref: setattr(ref, "value", float(v.sum())))
    mpi_send(tg0, g0, m, dest=1, tag=3)
    tg0.wait_all_tasks()
    tg1.wait_all_tasks()
    assert got.value == 15.0


def test_broadcast_order(engine):
    hub = ChannelHub()
    groups = [SpCommGroup(r, 3, hub) for r in range(3)]
    graphs = [SpTaskGraph().compute_on(engine) for _ in range(3)]
    first = torch.tensor([42.0])
    cells = [SpData(first if r == 0 else None, f"c{r}") for r in range(3)]
    cells2 = [SpData(7 if r == 0 else None, f"d{r}") for r in range(3)]
    for r in range(3):  # two back-to-back broadcasts: sequence tags match them
        mpi_broadcast(graphs[r], groups[r], cells[r], root=0)
        mpi_broadcast(graphs[r], groups[r], cells2[r], root=0)
    for g in graphs:
        g.wait_all_tasks()
    assert [float(c.value) for c in cells] == [42.0] * 3
    assert [c.value for c in cells2] == [7, 7, 7]


def test_serializer_roundtrip():
    s = SpSerializer()
    a = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    s.append_array(a)
    s.append_scalar(np.int64(5))
    d = SpDeserializer(s.buffer())
    a2, b2 = d.next_array(), d.next_array()
    assert isinstance(a2, torch.Tensor) and torch.equal(a2, a)
    assert b2.dtype == torch.int64 and int(b2) == 5


class Matrix:
    """Paper Code 7: an object using the serializer protocol."""

    def __init__(self, values):
        self.values = values

    def sp_serialize(self, s: SpSerializer) -> None:
        s.append_array(self.values)

    @classmethod
    def sp_deserialize(cls, d: SpDeserializer) -> "Matrix":
        return cls(d.next_array().clone())


def test_matrix_object_send_recv(engine):
    (g0, g1), (tg0, tg1) = _pair(engine)
    m = SpData(Matrix(torch.eye(3, dtype=torch.float64) * 2), "m")
    r = SpData(None, "r")
    mpi_recv(tg1, g1, r, src=0, tag=9)
    mpi_send(tg0, g0, m, dest=1, tag=9)
    tg0.wait_all_tasks()
    tg1.wait_all_tasks()
    assert isinstance(r.value, Matrix)
    assert torch.equal(r.value.values, torch.eye(3, dtype=torch.float64) * 2)


def test_failed_deserialization_fails_the_task_not_the_comm_thread(engine):
    """An ``sp_deserialize`` that raises on the receiving side fails its
    recv task (the error reaches the waiter); the comm thread lives on and
    serves the next request."""

    class Broken(Matrix):
        @classmethod
        def sp_deserialize(cls, d):
            raise ValueError("cannot rebuild")

    (g0, g1), (tg0, tg1) = _pair(engine)
    r = SpData(None, "r")
    view = mpi_recv(tg1, g1, r, src=0, tag=1)
    mpi_send(tg0, g0, SpData(Broken(torch.ones(2)), "m"), dest=1, tag=1)
    assert isinstance(view.exception(timeout=10.0), ValueError)
    r2 = SpData(None, "r2")
    mpi_recv(tg1, g1, r2, src=0, tag=2)
    mpi_send(tg0, g0, SpData(5, "m2"), dest=1, tag=2)
    tg0.wait_all_tasks()
    tg1.wait_all_tasks(timeout=10.0)
    assert r2.value == 5


# ---------------------------------------------------------------------------
# canonical wire codec
# ---------------------------------------------------------------------------

def test_wire_codec_roundtrips_pytrees():
    msg = {
        "arr": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": (1, [2.5, "text", None, True, b"\x00\xff"], {"k": -7}),
        "big": 1 << 80,
        "scalar": np.float64(3.25),  # a float subclass: an F frame
        "np32": np.float32(1.5),  # an A frame: a 0-d tensor
    }
    out = decode_message(encode_message(msg))
    assert torch.equal(out["arr"], msg["arr"])
    assert out["nested"] == (1, [2.5, "text", None, True, b"\x00\xff"], {"k": -7})
    assert out["big"] == 1 << 80
    assert out["scalar"] == 3.25
    assert out["np32"].dtype == torch.float32 and out["np32"].shape == () and float(out["np32"]) == 1.5
    # tuples stay tuples and lists stay lists (tags embed tuples as keys)
    assert isinstance(out["nested"], tuple) and isinstance(out["nested"][1], list)


def test_wire_codec_rejects_unencodable():
    with pytest.raises(TypeError, match="cannot serialize"):
        encode_message({"fn": lambda: None})
    with pytest.raises(TypeError, match="cannot serialize"):
        encode_message(torch.zeros(2, dtype=torch.float8_e4m3fn))


def test_deserialized_arrays_are_writable():
    s = SpSerializer()
    s.append_array(torch.arange(6, dtype=torch.float32))
    a = SpDeserializer(s.buffer()).next_array()
    a += 1.0  # must not raise
    assert torch.equal(a, torch.arange(6, dtype=torch.float32) + 1.0)
    b = decode_message(encode_message(torch.zeros((2, 2))))
    b[0, 0] = 5.0
    assert b[0, 0] == 5.0


_DTYPES = ["float16", "float32", "float64", "int8", "int16", "int32", "int64", "uint8", "bool"]
# repro's decoder splits the header on "|", which one-byte dtypes also use
# for their byte order ("|i1", "|u1", "|b1"): it cannot read its own frames
# of those (ROADMAP.md, known limits of the reference)
_REPRO_CANNOT_DECODE = {"int8", "uint8", "bool"}


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (2, 300)])
def test_encode_message_bytes_equal_repro(dtype, shape):
    """A CPU tensor encodes to the bytes ``repro.core.comm.encode_message``
    gives for the equal numpy array (shape (2, 300) crosses the zero-copy
    segment threshold for most dtypes); the port decodes ``repro``'s
    bytes, and ``repro`` decodes the port's, to equal values."""
    rng = np.random.default_rng(len(shape) * 16 + _DTYPES.index(dtype))
    vals = rng.standard_normal(shape) * 50
    if dtype == "bool":
        vals = vals > 0
    elif dtype.startswith(("int", "uint")):
        vals = np.clip(np.round(np.abs(vals) if dtype == "uint8" else vals), -100, 100)
    a = np.asarray(vals.astype(dtype))
    t = torch.from_numpy(a.copy())
    want = jcomm.encode_message({"g": a, "tag": ("x", 1)})
    assert encode_message({"g": t, "tag": ("x", 1)}) == want
    assert encode_message({"g": a, "tag": ("x", 1)}) == want  # numpy in, same bytes
    got = decode_message(want)["g"]
    assert isinstance(got, torch.Tensor) and got.dtype == t.dtype and got.shape == t.shape
    assert torch.equal(got, t)
    if dtype not in _REPRO_CANNOT_DECODE:
        back = jcomm.decode_message(encode_message(t))
        assert back.dtype == a.dtype and np.array_equal(back, a)


@pytest.mark.parametrize("shape", [(), (5,), (4, 700)])
def test_bf16_roundtrips_bit_for_bit(shape):
    t = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    t = t.to(torch.bfloat16)
    if t.dim():
        t.view(-1)[0] = float("nan")
        t.view(-1)[-1] = float("-inf")
    got = decode_message(encode_message({"w": t}))["w"]
    assert got.dtype == torch.bfloat16 and got.shape == t.shape
    assert torch.equal(got.view(torch.int16), t.view(torch.int16))
    segs, nbytes = encode_segments(t)
    assert segs[0] == b"W"  # its own frame: repro's decoder cannot read it
    assert nbytes == len(encode_message(t))


def test_large_tensors_travel_as_zero_copy_segments_and_decode_in_place():
    big = torch.arange(2048, dtype=torch.float32)
    segs, _ = encode_segments({"g": big})
    views = [s for s in segs if isinstance(s, memoryview)]
    assert len(views) == 1
    assert np.shares_memory(np.frombuffer(views[0], dtype=np.float32), big.numpy())
    frame = bytearray(b"".join(bytes(s) for s in encode_segments(big)[0]))
    out = decode_message(frame)  # a writable frame: the tensor aliases it
    assert np.shares_memory(out.numpy(), np.frombuffer(frame, dtype=np.uint8))
    out_copy = decode_message(bytes(frame))  # immutable: a private copy
    out_copy += 1
    assert torch.equal(out, big) and torch.equal(out_copy, big + 1)


# ---------------------------------------------------------------------------
# where a received tensor lands
# ---------------------------------------------------------------------------

def test_group_on_cpu_receives_cpu_tensors_from_the_hub_uncopied(engine):
    """A group on ``device="cpu"`` receives CPU tensors; over the hub a
    tensor already on the device passes through uncopied (the receiver
    aliases what was sent), and a broadcast lands the same way."""
    (g0, g1), (tg0, tg1) = _pair(engine, device="cpu")
    assert g1.device == torch.device("cpu") and g1.shrunk([]).device == g1.device
    sent = torch.arange(5, dtype=torch.float32)
    r, b = SpData(None, "r"), SpData(None, "b")
    mpi_recv(tg1, g1, r, src=0, tag="t")
    mpi_send(tg0, g0, SpData(sent, "m"), dest=1, tag="t")
    mpi_broadcast(tg0, g0, SpData({"w": sent}, "bm"), root=0)
    mpi_broadcast(tg1, g1, b, root=0)
    tg0.wait_all_tasks()
    tg1.wait_all_tasks()
    assert r.value.device.type == "cpu" and r.value.data_ptr() == sent.data_ptr()
    assert b.value["w"].data_ptr() == sent.data_ptr()


# ---------------------------------------------------------------------------
# mailbox hygiene
# ---------------------------------------------------------------------------

def test_hub_prunes_drained_mailboxes():
    hub = ChannelHub()
    for step in range(50):  # per-step tags: the unbounded-growth pattern
        hub.post((0, 1, ("step", step)), torch.tensor(step))
        ok, msg = hub.poll((0, 1, ("step", step)))
        assert ok and int(msg) == step
    st = hub.stats()
    assert st["boxes"] == 0 and st["queued"] == 0
    assert st["posted"] == 50 and st["delivered"] == 50


def test_hub_keeps_unread_messages():
    hub = ChannelHub()
    hub.post((0, 1, "a"), 1)
    hub.post((0, 1, "a"), 2)
    ok, msg = hub.poll((0, 1, "a"))
    assert ok and msg == 1
    assert hub.stats()["boxes"] == 1
    ok, msg = hub.poll((0, 1, "a"))
    assert ok and msg == 2
    assert hub.stats()["boxes"] == 0


def test_default_hub_reset():
    hub = default_hub()
    assert SpCommGroup(0, 2).hub is hub
    hub.post((0, 1, "stale"), "leftover")
    assert hub.stats()["queued"] >= 1
    reset_default_hub()
    assert hub.stats() == {"boxes": 0, "queued": 0, "posted": 0, "delivered": 0}


# ---------------------------------------------------------------------------
# timeout + shutdown semantics
# ---------------------------------------------------------------------------

def test_recv_timeout_surfaces_as_task_exception(engine):
    hub = ChannelHub()
    g1 = SpCommGroup(1, 2, hub)
    tg = SpTaskGraph().compute_on(engine)
    r, out = SpData(None, "r"), SpData("untouched", "out")
    view = mpi_recv(tg, g1, r, src=0, tag=99, timeout=0.1)
    dep = tg.task(SpRead(r), SpWrite(out), lambda v, ref: setattr(ref, "value", v))
    exc = view.exception(timeout=10.0)
    assert isinstance(exc, SpCommTimeoutError) and "tag=99" in str(exc)
    tg.wait_all_tasks(timeout=10.0)
    assert dep.state == "cancelled"
    assert out.value == "untouched"


@pytest.mark.parametrize("how", ["group default", "broadcast"])
def test_recv_times_out(engine, how):
    hub = ChannelHub()
    tg = SpTaskGraph().compute_on(engine)
    c = SpData(None, "c")
    if how == "group default":
        mpi_recv(tg, SpCommGroup(1, 2, hub, default_timeout=0.1), c, src=0, tag=5)
    else:  # the root never broadcasts
        mpi_broadcast(tg, SpCommGroup(1, 2, hub), c, root=0, timeout=0.1)
    with pytest.raises(SpCommTimeoutError):
        tg.wait_all_tasks()


def test_timely_recv_does_not_time_out(engine):
    (g0, g1), (tg0, tg1) = _pair(engine)
    r = SpData(None, "r")
    mpi_recv(tg1, g1, r, src=0, tag=1, timeout=30.0)
    mpi_send(tg0, g0, SpData(torch.tensor([41]), "m"), dest=1, tag=1)
    tg1.wait_all_tasks()
    assert int(r.value) == 41


def _wait_comm(eng):
    deadline = time.monotonic() + 5.0
    while eng._comm is None and time.monotonic() < deadline:
        time.sleep(0.005)  # wait for the task to reach the comm thread
    assert eng._comm is not None


def test_comm_stop_reports_in_flight_requests():
    eng = SpComputeEngine(SpWorkerTeamBuilder.team_of_cpu_workers(1))
    try:
        tg = SpTaskGraph().compute_on(eng)
        view = mpi_recv(tg, SpCommGroup(1, 2, ChannelHub()), SpData(None, "r"), src=0, tag=7)
        _wait_comm(eng)
        with pytest.warns(RuntimeWarning, match="in-flight"):
            aborted = eng._comm.stop(grace=0.2)
        assert aborted == ["recv(from=0,tag=7)"]
        assert isinstance(view.exception(timeout=5.0), SpCommAbortedError)
        tg.wait_all_tasks()
    finally:
        eng.stop()


def test_comm_abort_cancels_dependent_chain():
    eng = SpComputeEngine(SpWorkerTeamBuilder.team_of_cpu_workers(1))
    try:
        tg = SpTaskGraph().compute_on(eng)
        r, out = SpData(None, "r"), SpData(None, "out")
        view = mpi_recv(tg, SpCommGroup(1, 2, ChannelHub()), r, src=0, tag=11)
        dep = tg.task(SpRead(r), SpWrite(out), lambda v, ref: setattr(ref, "value", v))
        _wait_comm(eng)
        with pytest.warns(RuntimeWarning, match="in-flight"):
            assert eng.stop() == ["recv(from=0,tag=11)"]
        assert isinstance(view.exception(timeout=5.0), SpCommAbortedError)
        assert dep.state == "cancelled"
        tg.wait_all_tasks(timeout=5.0)
        assert out.value is None
    finally:
        eng.stop()


def test_clean_comm_shutdown_reports_nothing(engine):
    (g0, g1), (tg0, tg1) = _pair(engine)
    r = SpData(None, "r")
    mpi_recv(tg1, g1, r, src=0, tag=2)
    mpi_send(tg0, g0, SpData(torch.ones(3), "m"), dest=1, tag=2)
    tg1.wait_all_tasks()
    assert engine._comm.stop() == []
