"""The comm layer with tensors on the card (``repro_torch.core.comm``,
``dist.collectives``, ``launch.rendezvous``).

Marked ``cuda``: the tests skip on a machine without a Hopper card.  This
file imports no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_comm.py
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    ChannelHub,
    SocketTransport,
    SpCommGroup,
    SpComputeEngine,
    SpData,
    SpTaskGraph,
    SpWorkerTeamBuilder,
    SpWrite,
    decode_message,
    encode_message,
    mpi_recv,
    mpi_send,
)
from repro_torch.dist.collectives import ring_all_reduce  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import rendezvous as rdv  # noqa: E402


@pytest.fixture
def cuda_device():
    if not dispatch.cuda_available():
        pytest.skip("needs an sm_90 CUDA card")
    return torch.device("cuda")


@pytest.fixture()
def engine():
    eng = SpComputeEngine(SpWorkerTeamBuilder.team_of_cpu_cuda_workers(1, 2))
    yield eng
    eng.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64])
def test_codec_on_cuda_tensors(cuda_device, dtype):
    """A CUDA tensor encodes to the bytes of its host copy and decodes to a
    writable CPU tensor with the same bits."""
    t = (torch.arange(3000, device=cuda_device) % 97 - 40).to(dtype).reshape(30, 100)
    data = encode_message({"g": t})
    assert data == encode_message({"g": t.cpu()})
    got = decode_message(bytearray(data))["g"]
    assert got.device.type == "cpu" and got.dtype == dtype
    assert torch.equal(got, t.cpu())
    got += 1


def _sleeping_write(x, value: float) -> None:
    torch.cuda._sleep(1_000_000_000)  # ~0.5 s of a kernel ahead of the write
    x.fill_(value)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["hub to a cpu group", "sockets"])
def test_a_sent_tensor_arrives_as_written_behind_a_long_kernel(cuda_device, engine, wire):
    """A task on the card enqueues a long kernel and then a write, and
    returns at once; the send that follows copies the tensor to the host on
    the comm thread.  What arrives is the written value: the copy is
    ordered after the kernels on the stream."""
    if wire == "sockets":
        t0 = SocketTransport(0, 2)
        hubs = [t0, SocketTransport(1, 2, port=t0.port)]
    else:
        hubs = [ChannelHub()] * 2
    try:
        g0 = SpCommGroup(0, 2, hubs[0], device=cuda_device)
        g1 = SpCommGroup(1, 2, hubs[1], device="cpu")
        tg0, tg1 = (SpTaskGraph().compute_on(engine) for _ in range(2))
        x = SpData(torch.zeros(1 << 20, device=cuda_device), "x")
        r = SpData(None, "r")
        tg0.task(SpWrite(x), lambda ref: _sleeping_write(ref.value, 7.0))
        mpi_send(tg0, g0, x, dest=1, tag="w")
        mpi_recv(tg1, g1, r, src=0, tag="w", timeout=60.0)
        tg0.wait_all_tasks()
        tg1.wait_all_tasks()
        assert r.value.device.type == "cpu"
        assert torch.equal(r.value, torch.full((1 << 20,), 7.0))
    finally:
        for h in reversed(hubs):
            h.close()


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("chunk_bytes", [None, 4096])
def test_ring_all_reduce_on_the_card(cuda_device, engine, op, chunk_bytes):
    """Four ranks on one hub with groups on the card: every result is a
    CUDA tensor, bit for bit the ring-order replay of the inputs."""
    size, n = 4, 10007
    xs = [np.random.default_rng(r).standard_normal(n).astype(np.float32) for r in range(size)]
    hub = ChannelHub()
    groups = [SpCommGroup(r, size, hub, default_timeout=60.0, device=cuda_device)
              for r in range(size)]
    graphs = [SpTaskGraph().compute_on(engine) for _ in range(size)]
    cells = [SpData(torch.from_numpy(x).to(cuda_device), f"x{r}") for r, x in enumerate(xs)]
    for r in range(size):
        ring_all_reduce(graphs[r], groups[r], cells[r], op=op, chunk_bytes=chunk_bytes)
    for g in graphs:
        g.wait_all_tasks()
    want = rdv.ring_order_sum(xs)
    if op == "mean":
        want = want / np.float32(size)
    for c in cells:
        assert c.value.is_cuda
        np.testing.assert_array_equal(c.value.cpu().numpy(), want)


@pytest.mark.cuda
def test_spawned_ring_on_the_card(cuda_device):
    """Two rank processes on the one card over the socket transport: both
    results live on the card and equal the ring-order replay."""
    n = 4099
    results = rdv.run_ring_reduce(2, n, steps=2, device="cuda", timeout=240.0)
    want = rdv.ring_order_sum([np.random.default_rng(r).standard_normal(n).astype(np.float32)
                               for r in range(2)])
    for rep in results.values():
        assert rep["device"].startswith("cuda")
        np.testing.assert_array_equal(rep["sum"], want)
        np.testing.assert_array_equal(rep["mean"], want / np.float32(2))
