"""The CUDA kernels against their plain PyTorch versions, on an sm_90 card.

Marked ``cuda``: the tests skip on a machine without such a card (the CPU
runs check the plain versions against the JAX package in
``test_torch_kernels.py``).  This file imports no JAX, so it runs where the
card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# tests/test_kernels.py's tolerances
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda_device():
    if not dispatch.cuda_available():
        pytest.skip("needs an sm_90 CUDA card and nvcc")
    return torch.device("cuda")


def _close(got, want, dtype: str) -> None:
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(cuda_device, dtype):
    tdt = DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(tdt)

    ops = (rmsnorm_ops, flash_ops, decode_ops)
    before = [m.launches.count for m in ops]
    x, s = rnd(100, 256), rnd(256) * 0.1
    _close(rmsnorm_ops.rmsnorm(x, s), rmsnorm_ops.rmsnorm_ref(x, s), dtype)
    q, k, v = rnd(2, 77, 8, 64), rnd(2, 77, 2, 64), rnd(2, 77, 2, 64)
    _close(
        flash_ops.flash_attention(q, k, v, window=30),
        flash_ops.attention_ref(q, k, v, window=30), dtype,
    )
    pos = torch.tensor([0, 76], dtype=torch.int32, device=cuda_device)
    _close(
        decode_ops.decode_attention(q[:, :1], k, v, pos),
        decode_ops.decode_attention_ref(q[:, :1], k, v, pos), dtype,
    )
    after = [m.launches.count for m in ops]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = torch.randn(4, 64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm_ops.rmsnorm(x.t(), torch.zeros(4, device=cuda_device))
    with pytest.raises(TypeError, match="dtype"):
        rmsnorm_ops.rmsnorm(x.half(), torch.zeros(64, device=cuda_device).half())
    with pytest.raises(ValueError, match="tensors on"):
        rmsnorm_ops.rmsnorm(x, torch.zeros(64))
    q = torch.randn(1, 1, 4, 8, device=cuda_device)
    kv = torch.randn(1, 9, 2, 8, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        decode_ops.decode_attention(q, kv, kv, torch.tensor([3], device=cuda_device))


@pytest.mark.cuda
def test_decode_kernel_is_deterministic(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn(3, 1, 8, 128, generator=gen, device=cuda_device).bfloat16()
    k = torch.randn(3, 700, 8, 128, generator=gen, device=cuda_device).bfloat16()
    v = torch.randn(3, 700, 8, 128, generator=gen, device=cuda_device).bfloat16()
    pos = torch.tensor([699, 64, 300], dtype=torch.int32, device=cuda_device)
    first = decode_ops.decode_attention(q, k, v, pos)
    for _ in range(5):
        assert torch.equal(decode_ops.decode_attention(q, k, v, pos), first)
