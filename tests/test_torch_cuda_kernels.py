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
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402

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


@pytest.mark.cuda
@pytest.mark.parametrize("KH", [32, 8])
def test_decode_kernel_is_batch_invariant(cuda_device, KH):
    """Sequence b's output depends on its own q, cache and pos[b] only:
    sequence 0 beside empty slots (positions 0) is bit-equal to sequence 0
    beside live ones, as the serving check and speculative decoding need."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    B, S, H, D = 4, 2304, 32, 128
    q = torch.randn(B, 1, H, D, generator=gen, device=cuda_device).bfloat16()
    k = torch.randn(B, S, KH, D, generator=gen, device=cuda_device).bfloat16()
    v = torch.randn(B, S, KH, D, generator=gen, device=cuda_device).bfloat16()
    live = [2063, 792, 115, 336]
    for b in range(B):
        alone = [0] * B
        alone[b] = live[b]
        pos_alone = torch.tensor(alone, dtype=torch.int32, device=cuda_device)
        pos_live = torch.tensor(live, dtype=torch.int32, device=cuda_device)
        got_alone = decode_ops.decode_attention(q, k, v, pos_alone)[b]
        got_live = decode_ops.decode_attention(q, k, v, pos_live)[b]
        assert torch.equal(got_alone, got_live), b
        _close(got_live, decode_ops.decode_attention_ref(q, k, v, pos_live)[b], "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [("bfloat16", 12), ("float32", 6), ("float32", 20)])
def test_decode_kernel_element_wise_loads(cuda_device, dtype, D):
    """Head dims whose rows are not whole 16-byte chunks take element-wise
    loads into shared memory (and 20 f32 a partial 8-element lane group)."""
    tdt = DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.randn(3, 1, 6, D, generator=gen, device=cuda_device).to(tdt)
    k = torch.randn(3, 300, 2, D, generator=gen, device=cuda_device).to(tdt)
    v = torch.randn(3, 300, 2, D, generator=gen, device=cuda_device).to(tdt)
    pos = torch.tensor([299, 0, 130], dtype=torch.int32, device=cuda_device)
    _close(decode_ops.decode_attention(q, k, v, pos), decode_ops.decode_attention_ref(q, k, v, pos), dtype)


@pytest.mark.cuda
def test_decode_chunk_matches_the_plan(cuda_device):
    assert dispatch.library().decode_attention_chunk() == decode_ops.CHUNK


def _close_to_scale(got, want) -> None:
    """ssd outputs are float32 sums of up to cs·N products whatever the input
    type, so the limit scales with the output (chip_smoke.py's ssd limit)."""
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=5e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain(cuda_device, dtype):
    """The scan on a ragged L with B/C on 2 groups of 4 heads each, read in
    place, and the intra-chunk step alone on contiguous (b, H, nc, cs, ·)
    tensors with a chunk of 100 rows."""
    tdt = DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device)

    x, Bg, Cg = rnd(2, 300, 8, 64).to(tdt), rnd(2, 300, 2, 128).to(tdt), rnd(2, 300, 2, 128).to(tdt)
    dt = torch.nn.functional.softplus(rnd(2, 300, 8) - 1)
    A = -torch.exp(rnd(8) * 0.2)
    s0 = rnd(2, 8, 128, 64)
    before = ssd_ops.launches.count
    y, s = ssd_ops.ssd_chunked(x, dt, A, Bg, Cg, 128, s0)
    rep = lambda t: torch.repeat_interleave(t, 4, dim=2)  # noqa: E731
    y0, s_ref = ssd_ops.ssd_chunked_ref(x, dt, A, rep(Bg), rep(Cg), 128, s0)
    _close_to_scale(y, y0)
    _close_to_scale(s, s_ref)
    xc, Bc, Cc = rnd(2, 3, 3, 100, 64).to(tdt), rnd(2, 3, 3, 100, 128).to(tdt), rnd(2, 3, 3, 100, 128).to(tdt)
    dtc = torch.nn.functional.softplus(rnd(2, 3, 3, 100) - 1)
    cum = torch.cumsum(-dtc * 0.4, dim=-1)
    got, want = ssd_ops.ssd_intra_chunk(xc, dtc, cum, Bc, Cc), ssd_ops.ssd_chunk_ref(xc, dtc, cum, Bc, Cc)
    for g, w in zip(got, want):
        _close_to_scale(g, w)
    assert ssd_ops.launches.count - before == 2


# (B, Lq, Lk, H, KH, Dh, Dv, causal, window, q_offset): the tensor-core route
# at every padded head dim (64: Dh 8 / 32 / 64; 128: Dh 80 / 96 / 128), GQA
# and MQA, window, offset, non-causal, and ragged lengths around the 64-key
# and 128-query tiles
FLASH_BF16_CASES = [
    (1, 63, 63, 4, 4, 8, 8, True, None, 0),
    (2, 65, 65, 4, 2, 32, 32, True, None, 0),
    (1, 777, 777, 8, 2, 64, 64, True, None, 0),
    (1, 65, 65, 4, 4, 80, 80, True, None, 0),
    (2, 300, 300, 8, 8, 128, 128, True, None, 0),
    (1, 130, 130, 4, 2, 96, 64, True, None, 0),
    (2, 777, 777, 4, 1, 64, 64, True, 100, 0),
    (1, 63, 700, 8, 2, 64, 64, True, None, 637),
    (1, 1, 777, 4, 4, 128, 128, True, None, 776),
    (1, 1, 1, 2, 2, 128, 128, True, None, 0),
    (2, 333, 65, 4, 1, 128, 128, False, None, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_BF16_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_tensor_core_route_matches_plain(cuda_device, case):
    B, Lq, Lk, H, KH, Dh, Dv, causal, window, q_offset = case
    gen = torch.Generator(device=cuda_device).manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).bfloat16()

    q, k, v = rnd(B, Lq, H, Dh), rnd(B, Lk, KH, Dh), rnd(B, Lk, KH, Dv)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = flash_ops.launches.count
    got = flash_ops.flash_attention(q, k, v, **kw)
    assert flash_ops.launches.count - before == 1
    assert got.shape == (B, Lq, H, Dv)
    _close(got, flash_ops.attention_ref(q, k, v, **kw), "bfloat16")


@pytest.mark.cuda
def test_flash_tensor_core_route_rejects_unaligned_heads(cuda_device):
    """A head stride of 68 elements (a slice of a wider tensor) is not whole
    16-byte chunks: the bf16 wrapper raises instead of launching."""
    wide = torch.zeros(1, 16, 4, 68, device=cuda_device, dtype=torch.bfloat16)
    q = wide[..., :64]
    kv = torch.zeros(1, 16, 4, 64, device=cuda_device, dtype=torch.bfloat16)
    before = flash_ops.launches.count
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_ops.flash_attention(q, kv, kv)
    assert flash_ops.launches.count == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 37, 128, 768, 4096, 12288])
def test_rmsnorm_kernel_matches_plain(cuda_device, dtype, D):
    """Register path (16 / 128 / 768 / 4096), scalar path (37) and looped
    path (12288) against the plain version, at decode and prefill row
    counts."""
    tdt = DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    for T in (1, 8, 333):
        x = torch.randn(T, D, generator=gen, device=cuda_device).to(tdt)
        s = (torch.randn(D, generator=gen, device=cuda_device) * 0.1).to(tdt)
        _close(rmsnorm_ops.rmsnorm(x, s), rmsnorm_ops.rmsnorm_ref(x, s), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_unaligned_rows(cuda_device, dtype):
    """A contiguous slice one element into a buffer: no row starts on 16
    bytes, so the kernel takes its scalar path."""
    tdt = DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    T, D = 50, 768
    x = torch.randn(T * D + 1, generator=gen, device=cuda_device).to(tdt)[1:].view(T, D)
    s = (torch.randn(D, generator=gen, device=cuda_device) * 0.1).to(tdt)
    assert x.data_ptr() % 16 != 0
    plan = rmsnorm_ops.launch_plan(T, D, x.element_size(), aligned=False)
    assert plan.vec == 1
    _close(rmsnorm_ops.rmsnorm(x, s), rmsnorm_ops.rmsnorm_ref(x, s), dtype)


def _ssd_model_views(gen, dev, L, cs, H, G, dt_shift=-1.0):
    """ssd_chunked's views of model-layout inputs (L a multiple of cs):
    x / B / C as (1, H or G, nc, cs, ·) strided views, dt / cum (1, H, nc, cs)."""
    P, N, nc = 64, 128, L // cs
    x = torch.randn(1, L, H, P, generator=gen, device=dev).bfloat16()
    Bm = torch.randn(1, L, G, N, generator=gen, device=dev).bfloat16()
    Cm = torch.randn(1, L, G, N, generator=gen, device=dev).bfloat16()
    dt = torch.nn.functional.softplus(torch.randn(1, L, H, generator=gen, device=dev) + dt_shift)
    A = -torch.exp(torch.randn(H, generator=gen, device=dev) * 0.2)
    dtc = dt.reshape(1, nc, cs, H)
    cum = torch.cumsum(dtc * A, dim=2)
    heads_first = lambda t: t.reshape(1, nc, cs, t.shape[2], t.shape[3]).permute(0, 3, 1, 2, 4)  # noqa: E731
    return heads_first(x), dtc.permute(0, 3, 1, 2), cum.permute(0, 3, 1, 2), heads_first(Bm), heads_first(Cm)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "L,cs,H,G,dt_shift",
    [(2048, 256, 24, 1, -1.0), (2048, 256, 8, 8, -1.0), (300, 100, 24, 1, -1.0), (300, 100, 4, 4, -1.0),
     (5, 1, 24, 1, -1.0), (5, 1, 4, 4, -1.0), (512, 256, 24, 1, 3.0)],
    ids=lambda v: str(v),
)
def test_ssd_tensor_core_route_matches_plain(cuda_device, L, cs, H, G, dt_shift):
    """The bf16 route on the model's strided views: cs 256 / 100 / 1, one
    group or one group per head, and a strong decay (cum_i − cum_j > 100
    inside a chunk)."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    args = _ssd_model_views(gen, cuda_device, L, cs, H, G, dt_shift)
    if dt_shift > 0:
        assert float((args[2][..., 0] - args[2][..., -1]).max()) > 100
    before = ssd_ops.launches.count
    got = ssd_ops.ssd_intra_chunk(*args)
    assert ssd_ops.launches.count - before == 1
    for g, w in zip(got, ssd_ops.ssd_chunk_ref(*args)):
        _close_to_scale(g, w)


@pytest.mark.cuda
def test_ssd_tensor_core_route_rejects_unaligned(cuda_device):
    """x one element into its buffer is not whole 16-byte chunks, and a
    chunk of 512 rows is past what a block holds: the bf16 wrapper raises
    instead of launching."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x, dt, cum, B, C = _ssd_model_views(gen, cuda_device, 512, 256, 4, 1)
    shifted = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:].view(x.shape)
    before = ssd_ops.launches.count
    with pytest.raises(ValueError, match="multiples of 8"):
        ssd_ops.ssd_intra_chunk(shifted, dt, cum, B, C)
    x2, dt2, cum2, B2, C2 = _ssd_model_views(gen, cuda_device, 512, 512, 4, 1)
    with pytest.raises(ValueError, match="at most 256"):
        ssd_ops.ssd_intra_chunk(x2, dt2, cum2, B2, C2)
    assert ssd_ops.launches.count == before
