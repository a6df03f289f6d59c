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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,KH", [(256, 16), (192, 4), (136, 2)])
def test_decode_kernel_at_head_dims_above_128(cuda_device, dtype, D, KH):
    """gemma-7b's head dim (256, MHA) and two others padded to 256: the
    kernel against the plain version at per-slot positions, the same bits
    on a second run, and each sequence beside empty slots equal to itself
    beside the live ones."""
    tdt = DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    B, S, H = 4, 2304, 16
    q = torch.randn(B, 1, H, D, generator=gen, device=cuda_device).to(tdt)
    k = torch.randn(B, S, KH, D, generator=gen, device=cuda_device).to(tdt)
    v = torch.randn(B, S, KH, D, generator=gen, device=cuda_device).to(tdt)
    live = [2063, 792, 115, 336]
    pos = torch.tensor(live, dtype=torch.int32, device=cuda_device)
    before = decode_ops.launches.count
    first = decode_ops.decode_attention(q, k, v, pos)
    assert decode_ops.launches.count - before == 1
    _close(first, decode_ops.decode_attention_ref(q, k, v, pos), dtype)
    assert torch.equal(decode_ops.decode_attention(q, k, v, pos), first)
    for b in range(B):
        alone = torch.zeros_like(pos)
        alone[b] = live[b]
        assert torch.equal(decode_ops.decode_attention(q, k, v, alone)[b], first[b]), b


@pytest.mark.cuda
def test_kernels_reject_head_dims_above_256(cuda_device):
    """Above 256 every attention wrapper raises, naming the ROADMAP, and
    launches nothing; a bf16 head of 256 read from a 264-wide buffer is not
    whole 16-byte rows for the tensor-core copies and raises too."""
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(1, 16, 2, 264, device=cuda_device, dtype=dtype)
        lse = torch.zeros(1, 2, 16, device=cuda_device)
        pos = torch.tensor([15], dtype=torch.int32, device=cuda_device)
        counts = (flash_ops.launches.count, flash_ops.bwd_launches.count, decode_ops.launches.count)
        with pytest.raises(ValueError, match="ROADMAP"):
            flash_ops.flash_attention(x, x, x)
        with pytest.raises(ValueError, match="ROADMAP"):
            flash_ops.flash_attention_bwd(x, x, x, x, lse, x)
        with pytest.raises(ValueError, match="ROADMAP"):
            decode_ops.decode_attention(x[:, :1], x, x, pos)
        assert (flash_ops.launches.count, flash_ops.bwd_launches.count, decode_ops.launches.count) == counts
    wide = torch.zeros(1, 16, 2, 260, device=cuda_device, dtype=torch.bfloat16)
    kv = torch.zeros(1, 16, 2, 256, device=cuda_device, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 16, device=cuda_device)
    before = (flash_ops.launches.count, flash_ops.bwd_launches.count)
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_ops.flash_attention(wide[..., :256], kv, kv)
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_ops.flash_attention_bwd(kv, kv, kv, kv, lse, wide[..., :256])
    assert (flash_ops.launches.count, flash_ops.bwd_launches.count) == before


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_on_a_wrapped_ring(cuda_device, dtype):
    """recurrentgemma-9b's decode: 8 slots on a ring of 2048 (its window),
    one KV head of 256, positions that wrapped, did not, and sit on the
    boundary; against the plain version and the model's own rule on the
    CPU (``models.attention.decode_attention``)."""
    from repro_torch.models.attention import decode_attention

    tdt = DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    B, S, H, KH, D = 8, 2048, 16, 1, 256
    q = torch.randn(B, 1, H, D, generator=gen, device=cuda_device).to(tdt)
    k = torch.randn(B, S, KH, D, generator=gen, device=cuda_device).to(tdt)
    v = torch.randn(B, S, KH, D, generator=gen, device=cuda_device).to(tdt)
    pos = torch.tensor([4127, 2079, 808, 131, 1031, 4095, 2047, 2048], dtype=torch.int32, device=cuda_device)
    got = decode_ops.decode_attention(q, k, v, pos)
    _close(got, decode_ops.decode_attention_ref(q, k, v, pos), dtype)
    _close(got, decode_attention(q.cpu(), k.cpu(), v.cpu(), pos.cpu()), dtype)
    assert torch.equal(decode_ops.decode_attention(q, k, v, pos), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_slices", [2, 4])
def test_decode_partial_route_on_cache_slices(cuda_device, dtype, n_slices):
    """A sequence-sharded cache's decode: each slice of (4, 2304, 8, 128)
    through the partial route (one launch each) against the plain version
    (output within the dtype's tolerance, lse within 2e-5 absolute), run
    to run identical; the slices combined equal the whole-cache kernel's
    output within the same tolerance.  Positions put every slice's share
    in play: one past the last slot, one inside the first slice (later
    slices empty: lse -inf, output 0), one on a slice boundary, one past
    it by one."""
    tdt = DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    B, S, H, KH, D = 4, 2304, 8, 8, 128
    q = torch.randn(B, 1, H, D, generator=gen, device=cuda_device).to(tdt)
    k = torch.randn(B, S, KH, D, generator=gen, device=cuda_device).to(tdt)
    v = torch.randn(B, S, KH, D, generator=gen, device=cuda_device).to(tdt)
    Sl = S // n_slices
    pos = torch.tensor([S + 40, 100, Sl - 1, Sl], dtype=torch.int32, device=cuda_device)
    outs, lses = [], []
    for i in range(n_slices):
        ks, vs = k[:, i * Sl:(i + 1) * Sl], v[:, i * Sl:(i + 1) * Sl]
        before = decode_ops.launches.count
        out, lse = decode_ops.decode_attention(q, ks, vs, pos, i * Sl, partial=True)
        assert decode_ops.launches.count - before == 1
        assert out.dtype == lse.dtype == torch.float32
        ref_out, ref_lse = decode_ops.decode_attention_ref(q, ks, vs, pos, i * Sl, partial=True)
        _close(out, ref_out, dtype)
        finite = torch.isfinite(ref_lse)
        assert torch.equal(torch.isfinite(lse), finite)
        torch.testing.assert_close(lse[finite], ref_lse[finite], rtol=0, atol=2e-5)
        assert not out[~finite.cpu().to(cuda_device)[:, None, :]].any()  # an empty slice's output is 0
        again = decode_ops.decode_attention(q, ks, vs, pos, i * Sl, partial=True)
        assert torch.equal(again[0], out) and torch.equal(again[1], lse)
        outs.append(out)
        lses.append(lse)
    assert not torch.isfinite(lses[-1][1]).any()  # pos 100: the last slice holds nothing
    combined = decode_ops.combine_partials(torch.stack(outs), torch.stack(lses))
    _close(combined.to(tdt), decode_ops.decode_attention(q, k, v, pos), dtype)


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
    # padded head dim 256: gemma-7b's 256, 192, 136, Dh != Dv
    (1, 300, 300, 4, 4, 256, 256, True, None, 0),
    (2, 130, 130, 4, 2, 192, 192, True, 64, 0),
    (1, 65, 700, 4, 1, 136, 136, True, None, 635),
    (2, 333, 65, 2, 2, 256, 128, False, None, 0),
    (1, 1, 777, 2, 2, 256, 256, True, None, 776),
    # minicpm3-4b's MLA (Dk 96 != Dv 64, 40 heads); recurrentgemma-9b's
    # local attention (16 heads of 256 on one KV head, a window)
    (1, 300, 300, 40, 40, 96, 64, True, None, 0),
    (1, 600, 600, 16, 1, 256, 256, True, 256, 0),
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
@pytest.mark.parametrize("D", [16, 37, 128, 256, 768, 4096, 12288])
def test_rmsnorm_kernel_matches_plain(cuda_device, dtype, D):
    """Register path (16 / 128 / 256 / 768 / 4096), scalar path (37) and
    looped path (12288) against the plain version, at decode and prefill
    row counts."""
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


# ---------------------------------------------------------------------------
# The backward kernels (training) and the forward's lse
# ---------------------------------------------------------------------------

# backward outputs are float32 sums over a sequence (dK, dV over queries, dQ
# over keys), whatever the dtype, so their rounding error scales with the
# output's magnitude: the limit is atol·max|plain| + rtol·|plain|
BWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _close_scaled(got, want, dtype: str) -> None:
    want = want.float().cpu()
    tol = BWD_TOL[dtype]
    torch.testing.assert_close(got.float().cpu(), want, rtol=tol["rtol"],
                               atol=tol["atol"] * float(want.abs().max()))


# (B, Lq, Lk, H, KH, Dh, Dv, causal, window, q_offset): the path's head dim,
# GQA / MQA, a window, queries offset into a longer key range, one query
# row, ragged lengths around the 64-row tiles, a non-causal case, Dh 64 / 80
# / 96 (multiples of 8 padded to 64 or 128), Dh != Dv both ways, more queries
# than keys, a window without the causal mask, and a sequence long enough
# that the bf16 kernels' 2-stage rings turn many times
FLASH_BWD_CASES = [
    (1, 256, 256, 4, 4, 128, 128, True, None, 0),
    (2, 200, 200, 8, 2, 64, 64, True, 64, 0),
    (1, 65, 777, 4, 1, 128, 128, True, None, 712),
    (1, 1, 65, 4, 4, 64, 64, True, None, 64),
    (1, 130, 130, 4, 2, 80, 80, False, None, 0),
    (1, 300, 300, 8, 8, 96, 96, True, None, 0),
    (2, 333, 333, 8, 2, 128, 64, True, 100, 0),
    (1, 200, 260, 4, 4, 64, 128, True, None, 60),
    (1, 1024, 1024, 8, 8, 128, 128, True, None, 0),
    (1, 300, 200, 4, 2, 64, 64, True, None, 0),
    (1, 256, 256, 4, 4, 128, 128, False, 50, 0),
    # padded head dim 256 (the role-split bf16 kernels, the 32-row f32
    # tiles): gemma-7b's 256, GQA + window at 192, offset MQA, 136
    # non-causal, Dv < Dh
    (1, 256, 256, 4, 4, 256, 256, True, None, 0),
    (2, 200, 200, 4, 2, 192, 192, True, 64, 0),
    (1, 65, 777, 2, 1, 256, 256, True, None, 712),
    (1, 130, 130, 2, 2, 136, 136, False, None, 0),
    (1, 300, 300, 2, 2, 256, 64, True, None, 0),
    # minicpm3-4b's MLA and recurrentgemma-9b's windowed MQA at 256
    (1, 300, 300, 40, 40, 96, 64, True, None, 0),
    (1, 600, 600, 16, 1, 256, 256, True, 256, 0),
]


def _flash_bwd_inputs(gen, dev, case, tdt):
    B, Lq, Lk, H, KH, Dh, Dv, causal, window, q_offset = case
    q = torch.randn(B, Lq, H, Dh, generator=gen, device=dev).to(tdt)
    k = torch.randn(B, Lk, KH, Dh, generator=gen, device=dev).to(tdt)
    v = torch.randn(B, Lk, KH, Dv, generator=gen, device=dev).to(tdt)
    do = torch.randn(B, Lq, H, Dv, generator=gen, device=dev).to(tdt)
    return q, k, v, do, dict(causal=causal, window=window, q_offset=q_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_kernel_matches_plain(cuda_device, case, dtype):
    """(dq, dk, dv) of the kernel against ``attention_bwd_ref`` on the same
    out and lse (the plain forward's), and the same bits on a second run."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v, do, kw = _flash_bwd_inputs(gen, cuda_device, case, DTYPES[dtype])
    out, lse = flash_ops.attention_fwd_ref(q, k, v, **kw)
    before = flash_ops.bwd_launches.count
    got = flash_ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert flash_ops.bwd_launches.count - before == 1
    want = flash_ops.attention_bwd_ref(q, k, v, out, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close_scaled(g, w, dtype)
    again = flash_ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_forward_lse_matches_plain(cuda_device, case, dtype):
    """The forward's lse output (natural log, scaled scores) against the
    plain one: within 1e-4 (f32) / 1e-3 (bf16, whose kernel keeps its
    running max in the scaled log2 domain) of values of O(log Lk); out as
    without lse."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v, _, kw = _flash_bwd_inputs(gen, cuda_device, case, DTYPES[dtype])
    out, lse = flash_ops.flash_attention(q, k, v, return_lse=True, **kw)
    want_out, want_lse = flash_ops.attention_fwd_ref(q, k, v, **kw)
    assert lse.dtype == torch.float32 and lse.shape == want_lse.shape
    torch.testing.assert_close(lse.cpu(), want_lse.cpu(), rtol=0,
                               atol=1e-4 if dtype == "float32" else 1e-3)
    assert torch.equal(out, flash_ops.flash_attention(q, k, v, **kw))
    _close(out, want_out, dtype)


@pytest.mark.cuda
def test_flash_bwd_rejects_what_the_kernel_does_not_take(cuda_device):
    wide = torch.zeros(1, 16, 4, 68, device=cuda_device, dtype=torch.bfloat16)
    kv = torch.zeros(1, 16, 4, 64, device=cuda_device, dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 16, device=cuda_device)
    before = flash_ops.bwd_launches.count
    with pytest.raises(ValueError, match="multiples of 8"):  # the forward's bf16 rule
        flash_ops.flash_attention_bwd(kv, kv, kv, kv, lse, wide[..., :64])
    with pytest.raises(ValueError, match="lse"):
        flash_ops.flash_attention_bwd(kv, kv, kv, kv, lse.double(), kv)
    with pytest.raises(ValueError, match="dout"):
        flash_ops.flash_attention_bwd(kv, kv, kv, kv, lse, kv[:, :8])
    # an out or dout whose base is one element off 16 bytes: the bf16 kernels' copies refuse it
    shifted = torch.zeros(kv.numel() + 1, device=cuda_device, dtype=torch.bfloat16)[1:].view(kv.shape)
    with pytest.raises(ValueError, match="out"):
        flash_ops.flash_attention_bwd(kv, kv, kv, shifted, lse, kv)
    with pytest.raises(ValueError, match="dout"):
        flash_ops.flash_attention_bwd(kv, kv, kv, kv, lse, shifted)
    assert flash_ops.bwd_launches.count == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D", [(2048, 4096), (4096, 128), (333, 768), (3, 37), (7, 12288), (1, 16),
                                 (4096, 768), (65536, 128), (1000, 37)])
def test_rmsnorm_bwd_kernel_matches_plain(cuda_device, dtype, T, D):
    """Register (4096, 128, 768, 16), scalar (37) and looped (12288) paths,
    with few rows and with more rows than the plan's blocks hold at once:
    dx within the forward's tolerance, dscale (a sum over T rows) within
    the backward's scale-relative one; the same bits on a second run."""
    tdt = DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    x = torch.randn(T, D, generator=gen, device=cuda_device).to(tdt)
    s = (torch.randn(D, generator=gen, device=cuda_device) * 0.1).to(tdt)
    dy = torch.randn(T, D, generator=gen, device=cuda_device).to(tdt)
    before = rmsnorm_ops.bwd_launches.count
    dx, ds = rmsnorm_ops.rmsnorm_bwd(x, s, dy)
    assert rmsnorm_ops.bwd_launches.count - before == 1
    want_dx, want_ds = rmsnorm_ops.rmsnorm_bwd_ref(x, s, dy)
    _close(dx, want_dx, dtype)
    _close_scaled(ds, want_ds, dtype)
    dx2, ds2 = rmsnorm_ops.rmsnorm_bwd(x, s, dy)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_kernel_unaligned_rows(cuda_device, dtype):
    tdt = DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    T, D = 50, 768
    x = torch.randn(T * D + 1, generator=gen, device=cuda_device).to(tdt)[1:].view(T, D)
    dy = torch.randn(T * D + 1, generator=gen, device=cuda_device).to(tdt)[1:].view(T, D)
    s = (torch.randn(D, generator=gen, device=cuda_device) * 0.1).to(tdt)
    dx, ds = rmsnorm_ops.rmsnorm_bwd(x, s, dy)
    want_dx, want_ds = rmsnorm_ops.rmsnorm_bwd_ref(x, s, dy)
    _close(dx, want_dx, dtype)
    _close_scaled(ds, want_ds, dtype)


@pytest.mark.cuda
def test_autograd_functions_run_the_backward_kernels(cuda_device):
    """rmsnorm → flash attention under autograd: one forward and one
    backward launch of each, and gradients equal to the plain versions'."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    x = torch.randn(2, 64, 4, 64, generator=gen, device=cuda_device, requires_grad=True)
    s = torch.zeros(64, device=cuda_device, requires_grad=True)
    counters = (rmsnorm_ops.launches, rmsnorm_ops.bwd_launches, flash_ops.launches,
                flash_ops.bwd_launches)
    before = [c.count for c in counters]
    y = rmsnorm_ops.rmsnorm_train(x, s)
    out = flash_ops.flash_attention_train(y, y, y, causal=True)
    gx, gs = torch.autograd.grad(out.square().sum(), (x, s))
    assert [c.count - b for c, b in zip(counters, before)] == [1, 1, 1, 1]
    xr, sr = x.detach().cpu().requires_grad_(), s.detach().cpu().requires_grad_()
    yr = rmsnorm_ops.rmsnorm_train(xr, sr)
    rx, rs = torch.autograd.grad(flash_ops.flash_attention_train(yr, yr, yr).square().sum(), (xr, sr))
    _close_scaled(gx, rx, "float32")
    _close_scaled(gs, rs, "float32")


def _ssd_views(gen, dev, L, cs, H, G, dtype, dt_shift=-1.0):
    """``_ssd_model_views`` in ``dtype``, with float32 cotangents of y and
    the state: dy as the permuted view autograd hands the backward."""
    P, N, nc = 64, 128, L // cs
    x = torch.randn(1, L, H, P, generator=gen, device=dev).to(dtype)
    Bm, Cm = (torch.randn(1, L, G, N, generator=gen, device=dev).to(dtype) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn(1, L, H, generator=gen, device=dev) + dt_shift)
    A = -torch.exp(torch.randn(H, generator=gen, device=dev) * 0.2)
    dtc = dt.reshape(1, nc, cs, H)
    cum = torch.cumsum(dtc * A, dim=2)
    heads_first = lambda t: t.reshape(1, nc, cs, t.shape[2], t.shape[3]).permute(0, 3, 1, 2, 4)  # noqa: E731
    dy = torch.randn(1, nc, cs, H, P, generator=gen, device=dev).permute(0, 3, 1, 2, 4)
    dS = torch.randn(1, H, nc, N, P, generator=gen, device=dev)
    args = (heads_first(x), dtc.permute(0, 3, 1, 2), cum.permute(0, 3, 1, 2), heads_first(Bm), heads_first(Cm))
    return args, dy, dS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "L,cs,H,G,dt_shift",
    [(1024, 256, 24, 1, -1.0), (512, 256, 8, 8, -1.0), (300, 100, 24, 1, -1.0), (300, 100, 4, 4, -1.0),
     (5, 1, 4, 1, -1.0), (512, 256, 4, 1, 3.0)],
    ids=lambda v: str(v),
)
def test_ssd_bwd_kernel_matches_plain(cuda_device, dtype, L, cs, H, G, dt_shift):
    """The backward kernel against ``ssd_chunk_bwd_ref`` on the model's
    strided views: cs 256 / 100 / 1, one group or one group per head, and
    a strong decay (cum_i − cum_j > 100 inside a chunk) whose gradients
    stay finite; one launch, the same bits on a second run.  bfloat16 runs
    the tensor-core route (``csrc/ssd_bwd_wgmma.cu``), float32 the SIMT
    kernel."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    args, dy, dS = _ssd_views(gen, cuda_device, L, cs, H, G, DTYPES[dtype], dt_shift)
    if dt_shift > 0:
        assert float((args[2][..., 0] - args[2][..., -1]).max()) > 100
    before = ssd_ops.bwd_launches.count
    got = ssd_ops.ssd_intra_chunk_bwd(*args, dy, dS)
    assert ssd_ops.bwd_launches.count - before == 1
    want = ssd_ops.ssd_chunk_bwd_ref(*args, dy, dS)
    for g, w, a in zip(got, want, args):
        assert g.shape == a.shape and g.dtype == a.dtype and torch.isfinite(g.float()).all()
        _close_scaled(g, w, dtype)
    again = ssd_ops.ssd_intra_chunk_bwd(*args, dy, dS)
    assert all(torch.equal(g, h) for g, h in zip(got, again))


@pytest.mark.cuda
def test_ssd_bwd_tensor_core_route_rejects_unaligned(cuda_device):
    """bfloat16 x one element into its buffer is not in whole 16-byte
    chunks, and a chunk of 512 rows is past what the route holds: the
    backward raises ``ValueError`` and launches nothing (it never falls
    back to the SIMT kernel)."""
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    (x, dt, cum, B, C), dy, dS = _ssd_views(gen, cuda_device, 512, 256, 4, 1, torch.bfloat16)
    shifted = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:].view(x.shape)
    before = ssd_ops.bwd_launches.count
    with pytest.raises(ValueError, match="multiples of 8"):
        ssd_ops.ssd_intra_chunk_bwd(shifted, dt, cum, B, C, dy, dS)
    args, dy, dS = _ssd_views(gen, cuda_device, 512, 512, 4, 1, torch.bfloat16)
    with pytest.raises(ValueError, match="at most 256"):
        ssd_ops.ssd_intra_chunk_bwd(*args, dy, dS)
    assert ssd_ops.bwd_launches.count == before


@pytest.mark.cuda
def test_ssd_chunked_gradients_on_the_card(cuda_device):
    """Autograd through ``ssd_chunked`` on a ragged L with one group read in
    place and an initial state: one forward and one backward launch, and
    every gradient (x, dt, A, B, C, the initial state) equal to the CPU's
    plain autograd within the backward tolerance; the padded tail's rows
    get none."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device)

    L, H, P, N = 300, 8, 64, 128
    leaves = [rnd(2, L, H, P), torch.nn.functional.softplus(rnd(2, L, H) - 1), -torch.exp(rnd(H) * 0.2),
              rnd(2, L, 1, N), rnd(2, L, 1, N), rnd(2, H, N, P)]
    dy, ds = rnd(2, L, H, P), rnd(2, H, N, P)

    def grads(device):
        ts = [t.detach().to(device).requires_grad_() for t in leaves]
        y, s = ssd_ops.ssd_chunked(*ts[:5], 128, ts[5])
        return torch.autograd.grad((y * dy.to(device)).sum() + (s * ds.to(device)).sum(), ts)

    before = (ssd_ops.launches.count, ssd_ops.bwd_launches.count)
    got = grads(cuda_device)
    assert (ssd_ops.launches.count - before[0], ssd_ops.bwd_launches.count - before[1]) == (1, 1)
    for g, w in zip(got, grads("cpu")):
        _close_scaled(g, w, "float32")


@pytest.mark.cuda
def test_mamba2_train_step_on_the_card(cuda_device):
    """Reduced mamba2 in float32 under ``remat="full"``: one staged train
    step on the card against the CPU port from the same state (loss and
    grad norm within 1e-4 relative); the ssd kernel ran twice a layer
    (the forward and its recompute) and its backward once."""
    from repro_torch.configs import reduced_config
    from repro_torch.runtime.train import build_train_step, init_train_state

    cfg = reduced_config("mamba2-130m").replace(dtype="float32")
    assert cfg.remat == "full"
    gpu = init_train_state(cfg, 0, device=cuda_device)
    cpu = init_train_state(cfg, 0, device="cpu")
    with torch.no_grad():
        for (n, p), q in zip(gpu.params.named_parameters(), cpu.params.parameters()):
            q.copy_(p.cpu())
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    tokens = torch.randint(0, cfg.vocab, (2, 37), generator=gen, device=cuda_device, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    before = (ssd_ops.launches.count, ssd_ops.bwd_launches.count)
    gpu, mg = build_train_step(cfg)(gpu, batch)
    assert (ssd_ops.launches.count - before[0], ssd_ops.bwd_launches.count - before[1]) == (
        2 * cfg.n_layers, cfg.n_layers)
    cpu, mc = build_train_step(cfg)(cpu, {k: v.cpu() for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        g, c = float(mg[key]), float(mc[key])
        assert abs(g - c) <= 1e-4 * abs(c), (key, g, c)


@pytest.mark.cuda
def test_speculative_streams_equal_plain_on_the_card(cuda_device):
    """Reduced deepseek-7b in bf16: with the 1-layer shrunken draft at k = 4
    every verify sub-step and draft feed runs the decode-attention kernel,
    and the greedy streams equal the plain engine's."""
    import numpy as np

    from repro_torch.configs import reduced_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine, shrunken_draft

    cfg = reduced_config("deepseek-7b")
    model = init_params(cfg, 0, device=cuda_device)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (6, 9, 5)]
    draft_cfg, draft = shrunken_draft(cfg, model, n_layers=1)
    outs = []
    for kw in (dict(draft_cfg=draft_cfg, draft_params=draft), {}):
        with ServeEngine(cfg, model, n_slots=3, max_seq=48, block_size=4, device=cuda_device,
                         **kw) as eng:
            before = decode_ops.launches.count
            reqs = [eng.submit(p, 10) for p in prompts]
            eng.run_until_drained()
            assert decode_ops.launches.count > before
            outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card(cuda_device, tmp_path):
    """A bf16 Adafactor state trained on the card, saved and restored onto
    the card: every tensor bit-identical."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import reduced_config
    from repro_torch.runtime.train import build_train_step, init_train_state

    cfg = reduced_config("deepseek-7b").replace(optimizer="adafactor")
    state = init_train_state(cfg, 0, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen, device=cuda_device, dtype=torch.int32)
    state, _ = build_train_step(cfg)(state, {"tokens": tokens, "labels": tokens})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, block=True)
    step, restored = mgr.restore(state)
    assert step == 1 and restored.step.device.type == "cuda"
    pairs = list(zip(state.params.parameters(), restored.params.parameters()))
    pairs += [(state.opt[k][kk], restored.opt[k][kk]) for k in state.opt for kk in state.opt[k]]
    for a, b in pairs:
        assert b.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.element_size() == 2 else a.view(torch.int32),
                           b.view(torch.int16) if b.element_size() == 2 else b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm3-4b", "recurrentgemma-9b", "qwen3-moe-235b-a22b"])
def test_other_families_on_the_card(cuda_device, arch):
    """Reduced MLA, RG-LRU hybrid and MoE models in float32: prefill logits
    and 20 decode steps (past the hybrid's window of 16) on the card
    against the CPU port within 1e-4, then one staged train step's loss
    and grad norm within 1e-4 relative; the kernels of each path ran."""
    from repro_torch import models as tm
    from repro_torch.configs import reduced_config
    from repro_torch.runtime.serve import prime_cache
    from repro_torch.runtime.train import build_train_step, init_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(arch).replace(dtype="float32")
    gpu = init_train_state(cfg, 0, device=cuda_device)
    cpu = init_train_state(cfg, 0, device="cpu")
    with torch.no_grad():
        for p, q in zip(gpu.params.parameters(), cpu.params.parameters()):
            q.copy_(p.cpu())
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    tokens = torch.randint(0, cfg.vocab, (2, 21), generator=gen, device=cuda_device, dtype=torch.int32)
    before = (flash_ops.launches.count, decode_ops.launches.count, rmsnorm_ops.launches.count)
    with torch.no_grad():
        lg, cg = tm.prefill(gpu.params, {"tokens": tokens}, cfg)
        lc, cc = tm.prefill(cpu.params, {"tokens": tokens.cpu()}, cfg)
        _close(lg, lc, "float32")
        cg, cc = prime_cache(cfg, cg, 21, 48), prime_cache(cfg, cc, 21, 48)
        tok = torch.argmax(lc[:, 0], dim=-1).to(torch.int32)[:, None]
        for s in range(20):
            lg, cg = tm.decode_step(gpu.params, tok.to(cuda_device), cg, 21 + s, cfg)
            lc, cc = tm.decode_step(cpu.params, tok, cc, 21 + s, cfg)
            _close(lg, lc, "float32")
            tok = torch.argmax(lc[:, 0], dim=-1).to(torch.int32)[:, None]
    ran = (flash_ops.launches.count - before[0], decode_ops.launches.count - before[1],
           rmsnorm_ops.launches.count - before[2])
    assert ran[0] > 0 and ran[2] > 0 and (ran[1] > 0) == (cfg.mla is None), ran
    batch = {"tokens": tokens, "labels": tokens}
    gpu, mg = build_train_step(cfg, n_microbatches=2)(gpu, batch)
    cpu, mc = build_train_step(cfg, n_microbatches=2)(cpu, {k: v.cpu() for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        g, c = float(mg[key]), float(mc[key])
        assert abs(g - c) <= 1e-4 * abs(c), (key, g, c)


@pytest.mark.cuda
def test_hubert_train_step_on_the_card(cuda_device):
    """Reduced hubert-xlarge in float32 (the audio frontend, non-causal
    flash attention forward and backward inside the model): one staged
    train step (2 microbatches) on the card against the CPU port from the
    same state, loss and grad norm within 1e-4 relative; the flash kernel
    ran twice a layer and microbatch (forward and recompute) and its
    backward once; under ``remat="dots_saveable"`` the same step gives the
    same loss and grad norm bit for bit."""
    import numpy as np

    from repro_torch.configs import reduced_config
    from repro_torch.runtime.train import build_train_step, init_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config("hubert-xlarge").replace(dtype="float32")
    assert cfg.is_encoder and cfg.remat == "full"
    rng = np.random.default_rng(17)
    mask = np.zeros((4, 40), bool)
    mask[:, ::4] = True
    host = {"embeds": torch.from_numpy(rng.standard_normal((4, 40, 512)).astype(np.float32)),
            "mask": torch.from_numpy(mask),
            "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 40)).astype(np.int32))}
    batch = {k: v.to(cuda_device) for k, v in host.items()}
    runs = {}
    for remat in ("full", "dots_saveable"):
        c = cfg.replace(remat=remat)
        gpu = init_train_state(c, 0, device=cuda_device)
        before = (flash_ops.launches.count, flash_ops.bwd_launches.count)
        gpu, mg = build_train_step(c, n_microbatches=2)(gpu, batch)
        assert (flash_ops.launches.count - before[0], flash_ops.bwd_launches.count - before[1]) == (
            2 * 2 * cfg.n_layers, 2 * cfg.n_layers)
        runs[remat] = (float(mg["loss"]), float(mg["grad_norm"]))
    assert runs["full"] == runs["dots_saveable"], runs
    cpu = init_train_state(cfg, 0, device="cpu")
    gpu = init_train_state(cfg, 0, device=cuda_device)
    with torch.no_grad():
        for p, q in zip(gpu.params.parameters(), cpu.params.parameters()):
            q.copy_(p.cpu())
    cpu, mc = build_train_step(cfg, n_microbatches=2)(cpu, host)
    for key, g in zip(("loss", "grad_norm"), runs["full"]):
        c = float(mc[key])
        assert abs(g - c) <= 1e-4 * abs(c), (key, g, c)
