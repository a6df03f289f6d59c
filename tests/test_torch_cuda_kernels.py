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


def _fwd(ops, dtype: str):
    """The forward counter that a call in ``dtype`` moves at the main
    routes' widths: flash and ssd run float32 on their wide (SIMT) route,
    bfloat16 on the tensor cores; rmsnorm and decode have one route there."""
    return ops.wide_launches if dtype == "float32" and ops in (flash_ops, ssd_ops) else ops.launches


def _bwd(ops, dtype: str):
    """The backward counter of flash or ssd that a call in ``dtype`` moves."""
    return ops.wide_bwd_launches if dtype == "float32" else ops.bwd_launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(cuda_device, dtype):
    tdt = DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(tdt)

    ops = [_fwd(m, dtype) for m in (rmsnorm_ops, flash_ops, decode_ops)]
    before = [c.count for c in ops]
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
    after = [c.count for c in ops]
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
    """The name is historical: no route rejects these shapes any more.
    Above 256 every attention wrapper takes its wide route (one launch
    there, none on the main routes) and matches its plain version; a bf16
    head of 256 read from a 260-wide buffer is not whole 16-byte rows for
    the tensor-core copies and takes the wide route too."""
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    mains = lambda: (flash_ops.launches.count, flash_ops.bwd_launches.count, decode_ops.launches.count)  # noqa: E731
    wides = lambda: (flash_ops.wide_launches.count, flash_ops.wide_bwd_launches.count,  # noqa: E731
                     decode_ops.wide_launches.count)
    for dtype in ("float32", "bfloat16"):
        q, k, v, do = (torch.randn(1, 16, 2, 264, generator=gen, device=cuda_device).to(DTYPES[dtype])
                       for _ in range(4))
        out, lse = flash_ops.attention_fwd_ref(q, k, v)
        pos = torch.tensor([15], dtype=torch.int32, device=cuda_device)
        counts, w0 = mains(), wides()
        _close(flash_ops.flash_attention(q, k, v), out, dtype)
        for g, w in zip(flash_ops.flash_attention_bwd(q, k, v, out, lse, do),
                        flash_ops.attention_bwd_ref(q, k, v, out, lse, do)):
            _close_scaled(g, w, dtype)
        _close(decode_ops.decode_attention(q[:, :1], k, v, pos),
               decode_ops.decode_attention_ref(q[:, :1], k, v, pos), dtype)
        assert mains() == counts and [a - b for a, b in zip(wides(), w0)] == [1, 1, 1]
    wide = torch.randn(1, 16, 2, 260, generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = (torch.randn(1, 16, 2, 256, generator=gen, device=cuda_device).to(torch.bfloat16) for _ in range(3))
    out, lse = flash_ops.attention_fwd_ref(q, k, v)
    counts, w0 = mains(), wides()
    _close(flash_ops.flash_attention(wide[..., :256], k, v), flash_ops.attention_ref(wide[..., :256], k, v),
           "bfloat16")
    for g, w in zip(flash_ops.flash_attention_bwd(q, k, v, out, lse, wide[..., :256]),
                    flash_ops.attention_bwd_ref(q, k, v, out, lse, wide[..., :256])):
        _close_scaled(g, w, "bfloat16")
    assert mains() == counts and [a - b for a, b in zip(wides(), w0)] == [1, 1, 0]


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
    counter = _fwd(ssd_ops, dtype)
    before = counter.count
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
    assert counter.count - before == 2


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
    """The name is historical: the wrapper takes this shape on the wide
    route.  A head stride of 68 elements (a slice of a wider tensor) is not whole
    16-byte chunks: the tensor-core route does not take it, and the bf16
    wrapper launches the wide route instead, which matches plain."""
    gen = torch.Generator(device=cuda_device).manual_seed(32)
    wide = torch.randn(1, 16, 4, 68, generator=gen, device=cuda_device).to(torch.bfloat16)
    q = wide[..., :64]
    kv = torch.randn(1, 16, 4, 64, generator=gen, device=cuda_device).to(torch.bfloat16)
    assert not flash_ops.meets_tensor_core_layout(q=q)
    before, wide_before = flash_ops.launches.count, flash_ops.wide_launches.count
    _close(flash_ops.flash_attention(q, kv, kv), flash_ops.attention_ref(q, kv, kv), "bfloat16")
    assert flash_ops.launches.count == before and flash_ops.wide_launches.count == wide_before + 1


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
    """The name is historical: the wrapper takes these shapes on the wide
    route.  x one element into its buffer is not whole 16-byte chunks, and a
    chunk of 512 rows is past what a block holds: the tensor-core route
    takes neither, and the bf16 wrapper launches the wide route instead,
    which matches plain."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x, dt, cum, B, C = _ssd_model_views(gen, cuda_device, 512, 256, 4, 1)
    shifted = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:].view(x.shape)
    shifted.copy_(x)
    before, wide_before = ssd_ops.launches.count, ssd_ops.wide_launches.count
    for g, w in zip(ssd_ops.ssd_intra_chunk(shifted, dt, cum, B, C), ssd_ops.ssd_chunk_ref(shifted, dt, cum, B, C)):
        _close_to_scale(g, w)
    args = _ssd_model_views(gen, cuda_device, 512, 512, 4, 1)
    for g, w in zip(ssd_ops.ssd_intra_chunk(*args), ssd_ops.ssd_chunk_ref(*args)):
        _close_to_scale(g, w)
    assert ssd_ops.launches.count == before and ssd_ops.wide_launches.count == wide_before + 2


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
    counter = _bwd(flash_ops, dtype)
    before = counter.count
    got = flash_ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert counter.count - before == 1
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
    """The name is partly historical: only what no route takes is
    rejected.  That raises and launches nothing (an lse not float32,
    a dout not shaped like out); a dout, out or base off the bf16
    tensor-core route's 16-byte grid takes the wide route, which matches
    plain."""
    gen = torch.Generator(device=cuda_device).manual_seed(33)
    wide = torch.randn(1, 16, 4, 68, generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v, kv = (torch.randn(1, 16, 4, 64, generator=gen, device=cuda_device).to(torch.bfloat16)
                   for _ in range(4))
    out, lse = flash_ops.attention_fwd_ref(q, k, v)
    before, wide_before = flash_ops.bwd_launches.count, flash_ops.wide_bwd_launches.count
    with pytest.raises(ValueError, match="lse"):
        flash_ops.flash_attention_bwd(q, k, v, out, lse.double(), kv)
    with pytest.raises(ValueError, match="dout"):
        flash_ops.flash_attention_bwd(q, k, v, out, lse, kv[:, :8])
    assert flash_ops.wide_bwd_launches.count == wide_before
    # an out or dout whose base is one element off 16 bytes, a dout whose head stride is 68
    shifted_out, shifted_do = (
        torch.zeros(kv.numel() + 1, device=cuda_device, dtype=torch.bfloat16)[1:].view(kv.shape).copy_(t)
        for t in (out, kv))
    for o, do in ((out, wide[..., :64]), (shifted_out, kv), (out, shifted_do)):
        for g, w in zip(flash_ops.flash_attention_bwd(q, k, v, o, lse, do),
                        flash_ops.attention_bwd_ref(q, k, v, o, lse, do)):
            _close_scaled(g, w, "bfloat16")
    assert flash_ops.bwd_launches.count == before and flash_ops.wide_bwd_launches.count == wide_before + 3


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
    """rmsnorm → flash attention under autograd (float32: flash on its wide
    route): one forward and one backward launch of each, and gradients
    equal to the plain versions'."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    x = torch.randn(2, 64, 4, 64, generator=gen, device=cuda_device, requires_grad=True)
    s = torch.zeros(64, device=cuda_device, requires_grad=True)
    counters = (rmsnorm_ops.launches, rmsnorm_ops.bwd_launches, flash_ops.wide_launches,
                flash_ops.wide_bwd_launches)
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
    the tensor-core route (``csrc/ssd_bwd_wgmma.cu``), float32 the wide
    route's SIMT kernels (``csrc/ssd_wide.cu``)."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    args, dy, dS = _ssd_views(gen, cuda_device, L, cs, H, G, DTYPES[dtype], dt_shift)
    if dt_shift > 0:
        assert float((args[2][..., 0] - args[2][..., -1]).max()) > 100
    counter = _bwd(ssd_ops, dtype)
    before = counter.count
    got = ssd_ops.ssd_intra_chunk_bwd(*args, dy, dS)
    assert counter.count - before == 1
    want = ssd_ops.ssd_chunk_bwd_ref(*args, dy, dS)
    for g, w, a in zip(got, want, args):
        assert g.shape == a.shape and g.dtype == a.dtype and torch.isfinite(g.float()).all()
        _close_scaled(g, w, dtype)
    again = ssd_ops.ssd_intra_chunk_bwd(*args, dy, dS)
    assert all(torch.equal(g, h) for g, h in zip(got, again))


@pytest.mark.cuda
def test_ssd_bwd_tensor_core_route_rejects_unaligned(cuda_device):
    """The name is historical: the wrapper takes these shapes on the wide
    route.  bfloat16 x one element into its buffer is not in whole 16-byte
    chunks, and a chunk of 512 rows is past what the route holds: the
    tensor-core backward takes neither, and the wrapper launches the wide
    route (never the plain version), which matches plain."""
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    (x, dt, cum, B, C), dy, dS = _ssd_views(gen, cuda_device, 512, 256, 4, 1, torch.bfloat16)
    shifted = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:].view(x.shape)
    shifted.copy_(x)
    before, wide_before = ssd_ops.bwd_launches.count, ssd_ops.wide_bwd_launches.count
    cases = (((shifted, dt, cum, B, C), dy, dS), _ssd_views(gen, cuda_device, 512, 512, 4, 1, torch.bfloat16))
    for args, dy, dS in cases:
        for g, w in zip(ssd_ops.ssd_intra_chunk_bwd(*args, dy, dS), ssd_ops.ssd_chunk_bwd_ref(*args, dy, dS)):
            _close_scaled(g, w, "bfloat16")
    assert ssd_ops.bwd_launches.count == before and ssd_ops.wide_bwd_launches.count == wide_before + 2


@pytest.mark.cuda
def test_ssd_chunked_gradients_on_the_card(cuda_device):
    """Autograd through ``ssd_chunked`` on a ragged L with one group read in
    place and an initial state (float32: the wide route): one forward and
    one backward launch, and
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

    before = (ssd_ops.wide_launches.count, ssd_ops.wide_bwd_launches.count)
    got = grads(cuda_device)
    assert (ssd_ops.wide_launches.count - before[0], ssd_ops.wide_bwd_launches.count - before[1]) == (1, 1)
    for g, w in zip(got, grads("cpu")):
        _close_scaled(g, w, "float32")


@pytest.mark.cuda
def test_mamba2_train_step_on_the_card(cuda_device):
    """Reduced mamba2 in float32 under ``remat="full"``: one staged train
    step on the card against the CPU port from the same state (loss and
    grad norm within 1e-4 relative); the ssd kernel (float32: its wide
    route) ran twice a layer (the forward and its recompute) and its
    backward once."""
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
    before = (ssd_ops.wide_launches.count, ssd_ops.wide_bwd_launches.count)
    gpu, mg = build_train_step(cfg)(gpu, batch)
    assert (ssd_ops.wide_launches.count - before[0], ssd_ops.wide_bwd_launches.count - before[1]) == (
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
    and grad norm within 1e-4 relative; the kernels of each path ran
    (flash on its float32 wide route)."""
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
    before = (flash_ops.wide_launches.count, decode_ops.launches.count, rmsnorm_ops.launches.count)
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
    ran = (flash_ops.wide_launches.count - before[0], decode_ops.launches.count - before[1],
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
    (float32: its wide route) ran twice a layer and microbatch (forward and recompute) and its
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
        before = (flash_ops.wide_launches.count, flash_ops.wide_bwd_launches.count)
        gpu, mg = build_train_step(c, n_microbatches=2)(gpu, batch)
        assert (flash_ops.wide_launches.count - before[0], flash_ops.wide_bwd_launches.count - before[1]) == (
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


# ---------------------------------------------------------------------------
# The wide routes: every shape the main routes refuse
# ---------------------------------------------------------------------------

# (B, Lq, Lk, H, KH, Dh, Dv, causal, window, q_offset): head dims above 256
# (Dh != Dv, two Dv slices, a Dh walk of 5 steps + a ragged one), GQA / MQA,
# a window, offset queries, ragged lengths, a non-causal case; then widths
# the bf16 tensor-core route refuses (not multiples of 8); fp32 takes the
# wide route at every width
WIDE_FLASH_CASES = [
    (1, 130, 130, 4, 2, 320, 288, True, None, 0),
    (2, 77, 200, 4, 4, 512, 512, True, 50, 123),
    (1, 65, 65, 2, 1, 300, 600, False, None, 0),
    (1, 1, 129, 8, 8, 512, 512, True, None, 128),
    (1, 100, 100, 4, 2, 100, 100, True, None, 0),
    (2, 70, 90, 4, 4, 36, 20, False, 30, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", WIDE_FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_wide_route_matches_plain(cuda_device, case, dtype):
    """Forward (with lse) and backward on the route ``flash_ops.route``
    picks: the wide one above 256 or off the bf16 tensor-core grid, one
    launch each on its own counter; against the plain versions, and the
    same bits on a second run."""
    gen = torch.Generator(device=cuda_device).manual_seed(34)
    tdt = DTYPES[dtype]
    q, k, v, do, kw = _flash_bwd_inputs(gen, cuda_device, case, tdt)
    Dh, Dv = case[5], case[6]
    wide = flash_ops.route(Dh, Dv, tdt, Dh % 8 == 0 and Dv % 8 == 0) == "wide"
    assert wide == (tdt == torch.float32 or Dh > 256 or Dv > 256 or Dh % 8 != 0 or Dv % 8 != 0)
    fwd_c, bwd_c = ((flash_ops.wide_launches, flash_ops.wide_bwd_launches) if wide
                    else (flash_ops.launches, flash_ops.bwd_launches))
    before = (fwd_c.count, bwd_c.count)
    out, lse = flash_ops.flash_attention(q, k, v, return_lse=True, **kw)
    want_out, want_lse = flash_ops.attention_fwd_ref(q, k, v, **kw)
    _close(out, want_out, dtype)
    torch.testing.assert_close(lse.cpu(), want_lse.cpu(), rtol=0, atol=1e-4)
    got = flash_ops.flash_attention_bwd(q, k, v, want_out, want_lse, do, **kw)
    for g, w in zip(got, flash_ops.attention_bwd_ref(q, k, v, want_out, want_lse, do, **kw)):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close_scaled(g, w, dtype)
    assert (fwd_c.count - before[0], bwd_c.count - before[1]) == (1, 1)
    assert torch.equal(out, flash_ops.flash_attention(q, k, v, **kw))
    again = flash_ops.flash_attention_bwd(q, k, v, want_out, want_lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh,Dv,H,KH", [(320, 320, 8, 2), (512, 512, 8, 8), (300, 600, 4, 1)])
def test_decode_wide_route_matches_plain(cuda_device, dtype, Dh, Dv, H, KH):
    """Head dims above 256 on the wide decode route: positions in one chunk,
    across many and none valid; batch-invariant and the same bits on a
    second run; the partial route on two slices of the cache combines to
    the whole cache's output."""
    gen = torch.Generator(device=cuda_device).manual_seed(35)
    tdt = DTYPES[dtype]
    B, S = 4, 300
    q = torch.randn(B, 1, H, Dh, generator=gen, device=cuda_device).to(tdt)
    k = torch.randn(B, S, KH, Dh, generator=gen, device=cuda_device).to(tdt)
    v = torch.randn(B, S, KH, Dv, generator=gen, device=cuda_device).to(tdt)
    pos = torch.tensor([0, 63, 299, 150], dtype=torch.int32, device=cuda_device)
    before = (decode_ops.launches.count, decode_ops.wide_launches.count)
    out = decode_ops.decode_attention(q, k, v, pos)
    _close(out, decode_ops.decode_attention_ref(q, k, v, pos), dtype)
    assert torch.equal(out, decode_ops.decode_attention(q, k, v, pos))
    alone = torch.zeros_like(pos)
    alone[2] = pos[2]
    assert torch.equal(decode_ops.decode_attention(q, k, v, alone)[2], out[2])
    parts = [decode_ops.decode_attention(q, k[:, s0:s0 + 150], v[:, s0:s0 + 150], pos, slot_offset=s0,
                                         partial=True) for s0 in (0, 150)]
    for (o, lse), s0 in zip(parts, (0, 150)):
        want_o, want_lse = decode_ops.decode_attention_ref(q, k[:, s0:s0 + 150], v[:, s0:s0 + 150], pos, s0, True)
        _close(o, want_o, dtype)
        live = torch.isfinite(want_lse)
        assert torch.equal(live, torch.isfinite(lse))
        torch.testing.assert_close(lse[live].cpu(), want_lse[live].cpu(), rtol=1e-5, atol=2e-5)
    both = decode_ops.combine_partials(torch.stack([o for o, _ in parts]), torch.stack([lse for _, lse in parts]))
    _close(both.to(tdt), out, dtype)
    assert decode_ops.launches.count == before[0] and decode_ops.wide_launches.count - before[1] == 5


def _ssd_wide_views(gen, dev, b, L, cs, H, G, P, N, dtype, dt_shift=-1.0):
    """Model-layout ssd inputs at any (cs, P, N): x / B / C as strided
    (b, H or G, nc, cs, ·) views, dt / cum (b, H, nc, cs), and float32
    cotangents dy (a permuted view) and dS."""
    nc = L // cs
    x = torch.randn(b, L, H, P, generator=gen, device=dev).to(dtype)
    Bm, Cm = (torch.randn(b, L, G, N, generator=gen, device=dev).to(dtype) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn(b, L, H, generator=gen, device=dev) + dt_shift)
    A = -torch.exp(torch.randn(H, generator=gen, device=dev) * 0.2)
    dtc = dt.reshape(b, nc, cs, H)
    cum = torch.cumsum(dtc * A, dim=2)
    heads_first = lambda t: t.reshape(b, nc, cs, t.shape[2], t.shape[3]).permute(0, 3, 1, 2, 4)  # noqa: E731
    dy = torch.randn(b, nc, cs, H, P, generator=gen, device=dev).permute(0, 3, 1, 2, 4)
    dS = torch.randn(b, H, nc, N, P, generator=gen, device=dev)
    args = (heads_first(x), dtc.permute(0, 3, 1, 2), cum.permute(0, 3, 1, 2), heads_first(Bm), heads_first(Cm))
    return args, dy, dS


# (L, cs, H, G, P, N, dtype): P above 64 and N above 128 (one group, and one
# group of 2 heads), a chunk above 256, mamba2's wide variant (P 128, N 256,
# cs 512), and bf16 widths that are not multiples of 8; float32 takes the
# wide route at every shape
WIDE_SSD_CASES = [
    (96, 48, 4, 1, 96, 160, "float32"), (96, 48, 4, 2, 96, 160, "bfloat16"),
    (640, 320, 4, 1, 16, 16, "float32"), (640, 320, 4, 4, 16, 16, "bfloat16"),
    (1024, 512, 4, 1, 128, 256, "bfloat16"), (80, 40, 4, 1, 20, 12, "bfloat16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WIDE_SSD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_ssd_wide_route_matches_plain(cuda_device, case):
    """The ssd route ``ssd_ops.route`` picks (wide for every case) both ways on the model's strided views: one launch
    each on its route's counters, none on the other's, against the plain
    versions; the same bits on a second run; a strong decay stays finite."""
    L, cs, H, G, P, N, dtype = case
    gen = torch.Generator(device=cuda_device).manual_seed(36)
    tdt = DTYPES[dtype]
    wide = ssd_ops.route(cs, P, N, tdt, P % 8 == 0 and N % 8 == 0) == "wide"
    assert wide
    for shift in (-1.0, 3.0):
        args, dy, dS = _ssd_wide_views(gen, cuda_device, 2, L, cs, H, G, P, N, tdt, shift)
        before = (ssd_ops.launches.count, ssd_ops.bwd_launches.count, ssd_ops.wide_launches.count,
                  ssd_ops.wide_bwd_launches.count)
        got = ssd_ops.ssd_intra_chunk(*args)
        for g, w in zip(got, ssd_ops.ssd_chunk_ref(*args)):
            _close_to_scale(g, w)
        grads = ssd_ops.ssd_intra_chunk_bwd(*args, dy, dS)
        for g, w, a in zip(grads, ssd_ops.ssd_chunk_bwd_ref(*args, dy, dS), args):
            assert g.shape == a.shape and g.dtype == a.dtype and torch.isfinite(g.float()).all()
            _close_scaled(g, w, dtype)
        after = (ssd_ops.launches.count, ssd_ops.bwd_launches.count, ssd_ops.wide_launches.count,
                 ssd_ops.wide_bwd_launches.count)
        assert [a - b for a, b in zip(after, before)] == ([0, 0, 1, 1] if wide else [1, 1, 0, 0])
        assert all(torch.equal(a, b) for a, b in zip(got, ssd_ops.ssd_intra_chunk(*args)))
        assert all(torch.equal(a, b) for a, b in zip(grads, ssd_ops.ssd_intra_chunk_bwd(*args, dy, dS)))
