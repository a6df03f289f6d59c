"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version (the twin of
``repro``'s ``ref.py``); these tests hold it against ``repro``'s Pallas kernel
in interpret mode and against ``repro``'s ``ref.py`` over the sweeps of
``tests/test_kernels.py``, plus ragged lengths and the per-sequence decode
positions the TPU kernel lacks.  Inputs come from numpy with a seed and go
to both packages.  ``test_torch_cuda_kernels.py`` holds the CUDA kernels
against these plain versions on the card.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention.kernel import decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.rmsnorm.kernel import rmsnorm_pallas  # noqa: E402
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref  # noqa: E402
from repro.models.attention import decode_attention as jax_model_decode  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype: str) -> dict:
    # tests/test_kernels.py's tolerances
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _both(a: np.ndarray, dtype: str):
    """The same values in both frameworks (bf16 rounds identically)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype: str) -> None:
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,KH,L,D,bq,bk",
    [
        (1, 4, 4, 64, 32, 16, 16),   # MHA
        (2, 8, 2, 128, 64, 32, 64),  # GQA, rectangular blocks
        (1, 4, 1, 64, 16, 64, 16),   # MQA, single q block
        (1, 2, 2, 64, 256, 16, 16),  # gemma-7b's head dim
        (1, 2, 1, 64, 256, 32, 32),
    ],
)
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40), (False, None)])
def test_flash_plain_matches_pallas_sweep(dtype, B, H, KH, L, D, bq, bk, causal, window):
    rng = np.random.default_rng(0)
    qn = rng.standard_normal((B, H, L, D), np.float32)
    kn = rng.standard_normal((B, KH, L, D), np.float32)
    vn = rng.standard_normal((B, KH, L, D), np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (qn, kn, vn))
    pallas = flash_attention_pallas(
        qj, kj, vj, causal=causal, window=window, block_q=bq, block_kv=bk, interpret=True
    )
    ref = jax_attention_ref(qj, kj, vj, causal=causal, window=window)
    # the port's layout is the model's (B, L, H, D)
    out = flash_ops.flash_attention(
        qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2), causal=causal, window=window
    ).transpose(1, 2)
    assert out.dtype == DTYPES[dtype][1]
    _close(out, pallas, dtype)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "Lq,Lk,H,KH,q_offset,window",
    [(37, 37, 4, 2, 0, None), (100, 100, 8, 1, 0, 33), (20, 53, 4, 4, 33, None)],
)
def test_flash_plain_ragged_lengths(dtype, Lq, Lk, H, KH, q_offset, window):
    """Serving prompts have any length: no divisibility anywhere."""
    rng = np.random.default_rng(1)
    D = 16
    qn = rng.standard_normal((2, H, Lq, D), np.float32)
    kn = rng.standard_normal((2, KH, Lk, D), np.float32)
    vn = rng.standard_normal((2, KH, Lk, D), np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (qn, kn, vn))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    # one block spanning the whole ragged length keeps the Pallas asserts happy
    pallas = flash_attention_pallas(qj, kj, vj, block_q=Lq, block_kv=Lk, interpret=True, **kw)
    ref = jax_attention_ref(qj, kj, vj, **kw)
    out = flash_ops.flash_attention(
        qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2), **kw
    ).transpose(1, 2)
    _close(out, pallas, dtype)
    _close(out, ref, dtype)


def test_flash_model_qkv_meet_tensor_core_layout(monkeypatch):
    """The q / k / v that the model hands the flash kernel in bfloat16 pass
    the tensor-core route's alignment rule; a head slice does not.  So do
    the tensors the train path hands the backward kernel: the out that
    ``FlashAttentionFn`` saved and the dout that autograd brings, for every
    layer of a bfloat16 loss's backward."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import Transformer, loss_fn, set_trainable
    from repro_torch.models.attention import qkv_project

    cfg = reduced_config("deepseek-7b").replace(dtype="bfloat16")
    torch.manual_seed(0)
    model = Transformer(cfg, device="cpu")
    attn = next(m for m in model.modules() if hasattr(m, "wq"))
    x = torch.randn(2, 37, cfg.d_model).to(torch.bfloat16)
    q, k, v = qkv_project(attn, x, torch.arange(37), cfg)
    assert q.dtype == torch.bfloat16 and q.shape == (2, 37, cfg.n_heads, cfg.head_dim)
    assert flash_ops.meets_tensor_core_layout(q=q, k=k, v=v)
    assert not flash_ops.meets_tensor_core_layout(q=q[..., :12])

    seen = []
    plain_bwd = flash_ops.flash_attention_bwd

    def spy(q, k, v, out, lse, dout, **kw):
        seen.append((q, k, v, out, dout))
        return plain_bwd(q, k, v, out, lse, dout, **kw)

    monkeypatch.setattr(flash_ops, "flash_attention_bwd", spy)
    set_trainable(model)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 40)).astype(np.int32))
    loss, _ = loss_fn(model, {"tokens": tokens, "labels": tokens}, cfg)
    loss.backward()
    assert len(seen) == cfg.n_layers
    for q, k, v, out, dout in seen:
        assert out.dtype == dout.dtype == torch.bfloat16
        assert flash_ops.meets_tensor_core_layout(q=q, k=k, v=v, out=out, dout=dout)
        assert flash_ops.route(q.shape[-1], v.shape[-1], q.dtype) == "main"


def test_flash_rejects_nonpositive_window():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, q, q, window=0)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 17, 127, 255])
@pytest.mark.parametrize("B,H,KH,S,D", [(2, 8, 2, 256, 64), (1, 4, 4, 128, 32), (1, 2, 2, 128, 256)])
def test_decode_plain_matches_pallas_sweep(dtype, pos, B, H, KH, S, D):
    rng = np.random.default_rng(2)
    qn = rng.standard_normal((B, H, D), np.float32)
    kn = rng.standard_normal((B, KH, S, D), np.float32)
    vn = rng.standard_normal((B, KH, S, D), np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (qn, kn, vn))
    pallas = decode_attention_pallas(qj, kj, vj, jnp.int32(pos), block_s=64, interpret=True)
    ref = jax_decode_ref(qj, kj, vj, jnp.int32(pos))
    # the port: (B, 1, H, D) query, model-layout (B, S, KH, D) cache, (B,) pos
    out = decode_ops.decode_attention(
        qt[:, None], kt.transpose(1, 2), vt.transpose(1, 2),
        torch.full((B,), pos, dtype=torch.int32),
    )[:, 0]
    _close(out, pallas, dtype)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "S,window,pos",
    [
        (64, None, [0, 63, 17, 40]),   # full cache, per-slot positions incl. 0 and S-1
        (16, 16, [3, 15, 16, 200]),    # ring cache of window slots, pos past the window
    ],
)
def test_decode_plain_per_slot_pos_matches_model(dtype, S, window, pos):
    """The port's (B,) pos against ``repro.models.attention.decode_attention``
    — the JAX model's per-slot oracle (its Pallas kernel takes a scalar)."""
    rng = np.random.default_rng(3)
    B, H, KH, D = len(pos), 8, 2, 16
    qn = rng.standard_normal((B, 1, H, D), np.float32)
    kn = rng.standard_normal((B, S, KH, D), np.float32)
    vn = rng.standard_normal((B, S, KH, D), np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (qn, kn, vn))
    want = jax_model_decode(qj, kj, vj, jnp.asarray(pos, jnp.int32), window=window)
    out = decode_ops.decode_attention(qt, kt, vt, torch.tensor(pos, dtype=torch.int32))
    _close(out, want, dtype)


def test_decode_plain_output_shape():
    """A CPU call takes the plain version and keeps the (B, 1, H, Dv) layout."""
    q = torch.zeros(2, 1, 4, 8)
    kv = torch.zeros(2, 5, 2, 8)
    out = decode_ops.decode_attention(q, kv, kv, torch.tensor([1, 4], dtype=torch.int32))
    assert out.shape == (2, 1, 4, 8)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D", [(8, 64), (64, 256), (100, 128)])
def test_rmsnorm_plain_matches_pallas_sweep(dtype, T, D):
    rng = np.random.default_rng(4)
    (xj, xt) = _both(rng.standard_normal((T, D), np.float32), dtype)
    (sj, st) = _both((rng.standard_normal(D) * 0.1).astype(np.float32), dtype)
    pallas = rmsnorm_pallas(xj, sj, interpret=True)
    ref = jax_rmsnorm_ref(xj, sj)
    out = rmsnorm_ops.rmsnorm(xt, st)
    assert out.dtype == DTYPES[dtype][1]
    _close(out, pallas, dtype)
    _close(out, ref, dtype)


def test_rmsnorm_plain_leading_dims():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 5, 16), np.float32)
    s = rng.standard_normal(16).astype(np.float32) * 0.1
    out = rmsnorm_ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(s))
    want = jax_rmsnorm_ref(jnp.asarray(x.reshape(-1, 16)), jnp.asarray(s))
    _close(out.reshape(-1, 16), want, "float32")


def _rmsnorm_dims() -> list[int]:
    """Every d_model and head_dim of the port's configs and their reduced
    configs, and edges: tiny, not a multiple of the vector, past registers."""
    from repro_torch.configs import ARCH_NAMES, get_config, reduced_config

    cfgs = [get_config(n) for n in ARCH_NAMES] + [reduced_config(n) for n in ARCH_NAMES]
    return sorted({d for c in cfgs for d in (c.d_model, c.head_dim)} | {5, 16, 37, 12288})


def _plan_coverage(plan, D: int) -> np.ndarray:
    """How often the kernel's indexing (csrc/rmsnorm.cu) touches each element
    of a row under ``plan``."""
    counts = np.zeros(D, np.int64)
    nvec = D // plan.vec
    for t in range(plan.tpr):
        if plan.vpt:
            vis = [j * plan.tpr + t for j in range(plan.vpt)]
        else:
            vis = range(t, nvec, plan.tpr)
        for vi in vis:
            if vi < nvec:
                counts[vi * plan.vec:(vi + 1) * plan.vec] += 1
    return counts


@pytest.mark.parametrize("D", _rmsnorm_dims())
def test_rmsnorm_launch_plan_covers_every_element_once(D):
    for itemsize in (2, 4):
        for aligned in (True, False):
            for rows in (1, 8, 2048):
                plan = rmsnorm_ops.launch_plan(rows, D, itemsize, aligned)
                assert (_plan_coverage(plan, D) == 1).all(), (plan, D)
                assert plan.rows_per_block >= 1 and plan.blocks * plan.rows_per_block >= rows
                assert (plan.blocks - 1) * plan.rows_per_block < rows
                # on a card of 132 SMs: at most 1024 threads an SM, every
                # row still in some block's stride
                capped = rmsnorm_ops.launch_plan(rows, D, itemsize, aligned, sms=132)
                threads = plan.tpr * plan.rows_per_block
                assert capped[:4] == plan[:4] and 1 <= capped.blocks <= plan.blocks
                assert capped.blocks * threads <= 132 * 1024 or capped.blocks == plan.blocks
                assert threads % 32 == 0 and threads <= 256
                assert plan.tpr & (plan.tpr - 1) == 0
                assert plan.tpr <= 32 or plan.rows_per_block == 1
                assert 0 <= plan.vpt <= rmsnorm_ops.MAX_VPT
                if aligned and D % (16 // itemsize) == 0:
                    assert plan.vec == 16 // itemsize
                else:
                    assert plan.vec == 1


def test_rmsnorm_launch_plan_shapes():
    """The serving shapes: deepseek-7b's rows of 4096 bf16 (512 vectors) on
    one 256-thread block, mamba2's 768 (96 vectors) one warp a row with 3
    vectors a lane, qk-norm rows of 128 on 16 lanes; 12288 loops."""
    assert rmsnorm_ops.launch_plan(4, 4096, 2, True) == (8, 2, 256, 1, 4)
    assert rmsnorm_ops.launch_plan(8, 768, 2, True) == (8, 3, 32, 4, 2)
    assert rmsnorm_ops.launch_plan(2048, 128, 2, True) == (8, 1, 16, 8, 256)
    assert rmsnorm_ops.launch_plan(1, 12288, 2, True).vpt == 0
    assert rmsnorm_ops.launch_plan(2048, 4096, 2, True, sms=132).blocks == 528


def _bwd_rows_of_blocks(plan, rows: int) -> list:
    """The rows each block of the backward kernel (csrc/rmsnorm.cu) visits,
    by row group, in order: block b's groups are b·rpb + k·stride with
    stride = blocks·rpb, and row group ``sub`` takes row group + sub."""
    rpb, stride = plan.rows_per_block, plan.blocks * plan.rows_per_block
    out = []
    for b in range(plan.blocks):
        subs = [[] for _ in range(rpb)]
        for base in range(b * rpb, rows, stride):
            for sub in range(rpb):
                if base + sub < rows:
                    subs[sub].append(base + sub)
        out.append(subs)
    return out


def _bwd_dscale_emulated(plan, x, s, dy, eps=1e-6):
    """The backward kernel's reduction of dscale (csrc/rmsnorm.cu), in
    float32: each row group sums its rows in order; a block's row groups
    are added pairwise (groups [h, 2h) into [0, h), h halving from rpb / 2)
    into the block's one partial row; then 8 lanes sum every 8th block's
    row and are added in lane order.  → (dscale, plain dscale, the number
    of partial rows written)."""
    rows, D = x.shape
    _, want = rmsnorm_ops.rmsnorm_bwd_ref(x, s, dy, eps)
    xf = x.float()
    contrib = dy.float() * xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    parts = []
    for subs in _bwd_rows_of_blocks(plan, rows):
        acc = [torch.zeros(D) for _ in subs]
        for g, rs in enumerate(subs):
            for r in rs:
                acc[g] = acc[g] + contrib[r]
        h = len(acc) // 2
        while h:
            for g in range(h):
                acc[g] = acc[g] + acc[g + h]
            h //= 2
        parts.append(acc[0])
    parts = torch.stack(parts)
    lanes = [parts[j::8].sum(0) for j in range(8)]
    got = lanes[0]
    for lane in lanes[1:]:
        got = got + lane
    return got, want, parts.shape[0]


@pytest.mark.parametrize("rows,D,itemsize", [(2048, 4096, 2), (4096, 128, 2), (50, 768, 4),
                                             (3, 37, 4), (7, 12288, 2), (4096, 768, 2),
                                             (2100, 4096, 4)])
def test_rmsnorm_bwd_launch_plan_reduces_every_row_once(rows, D, itemsize):
    """The backward's plan keeps the forward's coverage of a row; on the
    register path a block holds 512 threads (a power-of-two number of row
    groups, for the pairwise sum) and, on a 132-SM card, one block an SM
    with every block walking as many rows as the others (within one); the
    looped path one row group a block and at most 512 threads an SM.  The
    blocks visit every row once; the kernel writes one partial row of D a
    block (a few MB at most) and its shared-memory sum fits in 48 KB; the
    partition, reduced as the kernel does, gives the plain dscale (within
    1e-5 of its largest magnitude: f32 sums in another order)."""
    for aligned in (True, False):
        fwd = rmsnorm_ops.launch_plan(rows, D, itemsize, aligned)
        for sms in (None, 132):
            plan = rmsnorm_ops.bwd_launch_plan(rows, D, itemsize, aligned, sms=sms)
            rpb, threads = plan.rows_per_block, plan.tpr * plan.rows_per_block
            assert plan[:3] == fwd[:3] and plan.blocks >= 1
            assert rpb & (rpb - 1) == 0 and threads % 32 == 0
            if plan.vpt:
                assert threads == rmsnorm_ops.BWD_THREADS
                assert (rpb // 2) * D * 4 <= 48 << 10
            else:
                assert rpb == 1 and threads <= rmsnorm_ops.BWD_THREADS
            visits = _bwd_rows_of_blocks(plan, rows)
            seen = sorted(r for subs in visits for rs in subs for r in rs)
            assert seen == list(range(rows)), plan
            assert all(any(subs) for subs in visits)  # every block writes its partial row
            if sms is None:
                assert plan.blocks == -(-rows // rpb)
            else:
                assert plan.blocks * threads <= 132 * rmsnorm_ops.BWD_THREADS
                walks = [max(len(rs) for rs in subs) for subs in visits]
                assert max(walks) - min(walks) <= 1
                assert plan.blocks * D * 4 <= 8 << 20
    gen = torch.Generator().manual_seed(0)
    x, dy = torch.randn(rows, D, generator=gen), torch.randn(rows, D, generator=gen)
    s = 0.1 * torch.randn(D, generator=gen)
    got, want, n_parts = _bwd_dscale_emulated(plan, x, s, dy)
    assert n_parts == plan.blocks
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_rmsnorm_bwd_launch_plan_shapes():
    """The train path's rows: deepseek-7b's (2048, 4096) bf16 on 128 blocks
    of two 256-thread row groups (8 rows each), one block an SM of 132;
    mamba2's 768 on 16 warps a block; qk-norm rows of 128 on 32 groups of
    16 lanes; 12288 loops on one row group a block."""
    assert rmsnorm_ops.bwd_launch_plan(2048, 4096, 2, True, sms=132) == (8, 2, 256, 2, 128)
    assert rmsnorm_ops.bwd_launch_plan(4096, 768, 2, True, sms=132) == (8, 3, 32, 16, 128)
    assert rmsnorm_ops.bwd_launch_plan(65536, 128, 2, True, sms=132) == (8, 1, 16, 32, 128)
    assert rmsnorm_ops.bwd_launch_plan(7, 12288, 2, True, sms=132) == (8, 0, 256, 1, 7)
    assert rmsnorm_ops.bwd_launch_plan(1, 4096, 2, True, sms=132) == (8, 2, 256, 2, 1)


# ---------------------------------------------------------------------------
# ssd: the tensor-core route's arithmetic, launch plan and layout rule
# ---------------------------------------------------------------------------

# chip_smoke.py's and test_torch_cuda_kernels.py's ssd limit:
# SSD_ATOL·max|plain| + SSD_RTOL·|plain|
SSD_ATOL, SSD_RTOL = 5e-5, 1e-4


def _bf16_split(w: torch.Tensor):
    hi = w.to(torch.bfloat16).float()
    return hi, (w - hi).to(torch.bfloat16).float()


def _ssd_tc_emulate(x, dt, cum, B, C, *, split=True):
    """csrc/ssd.cu's bf16 route in plain torch on (..., nc, cs, ·) f32
    tensors holding bf16 values: f32 scores of exact bf16 products; per
    64-row (i, j <= i) tile pair the decay weights W in f32, split into
    bf16 hi + lo, accumulated into y in f32 tile by tile (hi then lo); the
    state from (B ∘ w) split the same way, tile by tile over j.  (The
    kernel's decay is 2^x on the MUFU unit, within ~1e-6 of exp here.)  With
    ``split=False`` W and B ∘ w are rounded to bf16 alone."""
    cs, T = x.shape[-2], ssd_ops.TILE
    n_tiles = -(-cs // T)
    S = C @ B.transpose(-1, -2)
    ii = torch.arange(cs)
    y = torch.zeros(x.shape)
    for it in range(n_tiles):
        i = slice(it * T, min(cs, it * T + T))
        for jt in range(it + 1):
            j = slice(jt * T, min(cs, jt * T + T))
            keep = ii[i, None] >= ii[None, j]
            decay = torch.exp(cum[..., i, None] - cum[..., None, j])
            w = torch.where(keep, S[..., i, j] * decay * dt[..., None, j], torch.zeros(()))
            hi, lo = _bf16_split(w) if split else (w.to(torch.bfloat16).float(), torch.zeros(()))
            y[..., i, :] = y[..., i, :] + hi @ x[..., j, :]
            if split:
                y[..., i, :] = y[..., i, :] + lo @ x[..., j, :]
    wts = torch.exp(cum[..., -1:] - cum) * dt
    state = torch.zeros(x.shape[:-2] + (B.shape[-1], x.shape[-1]))
    for jt in range(n_tiles):
        j = slice(jt * T, min(cs, jt * T + T))
        a = (B[..., j, :] * wts[..., j, None]).transpose(-1, -2)
        hi, lo = _bf16_split(a) if split else (a.to(torch.bfloat16).float(), torch.zeros(()))
        state = state + hi @ x[..., j, :]
        if split:
            state = state + lo @ x[..., j, :]
    return y, state


def _ssd_bf16_chunks(L, cs, H, P, N, *, seed, dt_shift=-1.0):
    """chip_smoke.py's ssd inputs, drawn with numpy: x, B, C rounded to bf16
    (held as f32), dt = softplus(randn + dt_shift), A < 0; one group, B / C
    broadcast over the heads; → (b·H, nc, cs, ·) chunks and cum."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float()  # noqa: E731
    x = bf(rng.standard_normal((L, H, P)))
    Bm, Cm = bf(rng.standard_normal((L, N))), bf(rng.standard_normal((L, N)))
    dt = torch.nn.functional.softplus(torch.from_numpy(rng.standard_normal((L, H)).astype(np.float32)) + dt_shift)
    A = -torch.exp(torch.from_numpy(rng.standard_normal(H).astype(np.float32)) * 0.2)
    nc = L // cs
    chunks = lambda t: t.reshape(nc, cs, H, -1).permute(2, 0, 1, 3)  # noqa: E731
    dtc = dt.reshape(nc, cs, H).permute(2, 0, 1)
    cum = torch.cumsum(dtc * A[:, None, None], dim=-1)
    Bc = Bm.reshape(nc, cs, N).expand(H, nc, cs, N)
    Cc = Cm.reshape(nc, cs, N).expand(H, nc, cs, N)
    return chunks(x), dtc, cum, Bc, Cc


def _ssd_within(got, want) -> bool:
    return bool(((got - want).abs() <= SSD_ATOL * want.abs().max() + SSD_RTOL * want.abs()).all())


@pytest.mark.parametrize("L,dt_shift", [(2048, -1.0), (512, 3.0)], ids=["serving-shape", "strong-decay"])
def test_ssd_tensor_core_arithmetic_meets_the_kept_tolerance(L, dt_shift):
    """The hi / lo split keeps the bf16 route inside the f32 tolerance that
    is kept, at the serving shape (cs 256, H 24, P 64, N 128, one group) and
    with a decay so strong that cum_i − cum_j passes 100 inside a chunk;
    rounding W to bf16 alone does not."""
    args = _ssd_bf16_chunks(L, 256, 24, 64, 128, seed=7, dt_shift=dt_shift)
    cum = args[2]
    if dt_shift > 0:
        assert float((cum[..., 0] - cum[..., -1]).max()) > 100
    want = ssd_ops.ssd_chunk_ref(*args)
    got = _ssd_tc_emulate(*args)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _ssd_within(g, w)
    y_hi_only, _ = _ssd_tc_emulate(*args, split=False)
    assert not _ssd_within(y_hi_only, want[0])


@pytest.mark.parametrize("cs", [1, 36, 100, 256])
def test_ssd_tensor_core_plan_covers_every_tile_once(cs):
    """Every causal (i tile, j tile <= i tile) pair of a chunk and every
    state row over every j tile is computed by exactly one block; at cs = 256
    the two blocks do 5 tile products each."""
    n_tiles = -(-cs // ssd_ops.TILE)
    for N in (128, 64, 16):
        plan = ssd_ops.tc_launch_plan(cs, N)
        assert [blk.half for blk in plan] == [0, 1]
        pairs = [(it, jt) for blk in plan for it, js in blk.y_tiles for jt in js]
        assert sorted(pairs) == [(i, j) for i in range(n_tiles) for j in range(i + 1)]
        rows = [n for blk in plan for n in range(*blk.state_rows)]
        assert sorted(rows) == list(range(N))
        for blk in plan:
            if blk.state_rows[0] < blk.state_rows[1]:
                assert blk.state_j_tiles == tuple(range(n_tiles))
        if cs == 256:
            assert [sum(len(js) for _, js in blk.y_tiles) for blk in plan] == [5, 5]


# chip_smoke.py's and test_torch_cuda_kernels.py's backward limit for
# bf16: BWD_ATOL·max|plain| + BWD_RTOL·|plain|
BWD_ATOL, BWD_RTOL = 2e-2, 2e-2


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _ssd_bwd_tc_emulate(x, dt, cum, B, C, dy, dS):
    """csrc/ssd_bwd_wgmma.cu in plain torch on (H, nc, cs, ·) f32 tensors
    holding bf16 x / B / C: dy and dS rounded once to bf16 (the conversion
    pass); per 64-row (j tile, i tile >= j tile) pair the column role's f32
    Sᵀ, dWᵀ, decay, W, G, M = G·s, ddt and colsum(M) sums and its column
    sums of M over each warp's 16 j rows (rowsum(M)'s parts), then W and G
    rounded once to bf16 for dx += Wᵀ·dy and dB += Gᵀ·C; the row role's dC
    += bf16(G)·B; the state terms from U = x·bf16(dS)ᵀ and V = B·bf16(dS) in
    f32.  Partial sums are kept per warpgroup (every other partner tile) and
    added warpgroup 0's first, U's dB term in warpgroup 0's; dcum is (−colsum
    − q) + (the parts of rowsum in (tile, warp) order + the warps' sums of q
    on the last row).  dx, dB and dC are rounded to bf16 at the end, as the
    kernel stores them; dB and dC are per head (the caller sums a group)."""
    cs, T = x.shape[-2], ssd_ops.TILE
    n_tiles = -(-cs // T)
    dyb, dSb = _bf16(dy), _bf16(dS)
    ii = torch.arange(cs)
    zero = torch.zeros(())
    # per warpgroup: dx, dB, dC, ddt, colsum partials
    dx, dB, dC = (torch.zeros((2,) + t.shape) for t in (x, B, C))
    ddt, col = torch.zeros((2,) + dt.shape), torch.zeros((2,) + dt.shape)
    rowpart = torch.zeros(dt.shape[:-1] + (n_tiles, 4, cs))  # (j tile, warp)
    tile = lambda t: slice(t * T, min(cs, t * T + T))  # noqa: E731
    for jt in range(n_tiles):  # the column role
        j = tile(jt)
        for it in range(jt, n_tiles):
            i, w = tile(it), (it - jt) % 2
            keep = ii[j, None] <= ii[None, i]  # (j, i): i >= j
            s = B[..., j, :] @ C[..., i, :].transpose(-1, -2)
            dw = x[..., j, :] @ dyb[..., i, :].transpose(-1, -2)
            decay = torch.exp(torch.where(keep, cum[..., None, i] - cum[..., j, None], zero))
            sl = s * decay
            g = torch.where(keep, dw * decay * dt[..., j, None], zero)
            m = g * s
            ddt[w][..., j] += torch.where(keep, dw * sl, zero).sum(-1)
            col[w][..., j] += m.sum(-1)
            for warp in range(4):  # warp holds the tile's j rows 16·warp .. 16·warp + 15
                rowpart[..., jt, warp, i] = m[..., 16 * warp:16 * warp + 16, :].sum(-2)
            wt = torch.where(keep, sl * dt[..., j, None], zero)
            dx[w][..., j, :] += _bf16(wt) @ dyb[..., i, :]
            dB[w][..., j, :] += _bf16(g) @ C[..., i, :]
    for it in range(n_tiles):  # the row role
        i = tile(it)
        for jt in range(it + 1):
            j = tile(jt)
            keep = ii[i, None] >= ii[None, j]
            dw = dyb[..., i, :] @ x[..., j, :].transpose(-1, -2)
            decay = torch.exp(torch.where(keep, cum[..., i, None] - cum[..., None, j], zero))
            g = torch.where(keep, dw * decay * dt[..., None, j], zero)
            dC[jt % 2][..., i, :] += _bf16(g) @ B[..., j, :]
    e = torch.exp(cum[..., -1:] - cum)
    coef = e * dt
    U, V = x @ dSb.transpose(-1, -2), B @ dSb
    bu = (B * U).sum(-1)
    q = coef * bu
    dx = (dx[0] + dx[1]) + coef[..., None] * V
    dB = (dB[0] + coef[..., None] * U) + dB[1]
    ddt = (ddt[0] + ddt[1]) + e * bu
    rows = rowpart.flatten(-3, -2).sum(-2)
    qw = torch.nn.functional.pad(q, (0, n_tiles * T - cs)).unflatten(-1, (n_tiles * 4, 16)).sum(-1)
    rows[..., -1] += qw.sum(-1)
    dcum = (-(col[0] + col[1]) - q) + rows
    return _bf16(dx), ddt, dcum, _bf16(dB), _bf16(dC[0] + dC[1])


def _bwd_within(got, want) -> bool:
    return bool(((got - want).abs() <= BWD_ATOL * want.abs().max() + BWD_RTOL * want.abs()).all())


@pytest.mark.parametrize(
    "L,cs,dt_shift", [(2048, 256, -1.0), (512, 256, 3.0), (300, 100, -1.0), (5, 1, -1.0)],
    ids=["train-shape", "strong-decay", "cs100", "cs1"],
)
def test_ssd_bwd_tensor_core_arithmetic_meets_the_kept_tolerance(L, cs, dt_shift):
    """Rounding dy, dS, W and G once to bf16 keeps the bf16 backward route
    inside the backward tolerance that is kept (2e-2·max|plain| +
    2e-2·|plain|), at the train shape (cs 256, H 24, P 64, N 128, one
    group), with a decay whose span inside a chunk passes 88 (every
    gradient finite), and at cs 100 and cs 1; at cs 1 dcum cancels to
    exactly 0."""
    args = _ssd_bf16_chunks(L, cs, 24, 64, 128, seed=19, dt_shift=dt_shift)
    cum = args[2]
    if dt_shift > 0:
        assert float((cum[..., 0] - cum[..., -1]).max()) > 88
    rng = np.random.default_rng(20)
    H, nc = args[0].shape[:2]
    dy = torch.from_numpy(rng.standard_normal((H, nc, cs, 64)).astype(np.float32))
    dS = torch.from_numpy(rng.standard_normal((H, nc, 128, 64)).astype(np.float32))
    want = list(ssd_ops.ssd_chunk_bwd_ref(*args, dy, dS))
    got = list(_ssd_bwd_tc_emulate(*args, dy, dS))
    for k in (3, 4):  # one group: dB and dC sum the heads
        want[k], got[k] = want[k].sum(0), got[k].sum(0)
    for name, g, w in zip(("dx", "ddt", "dcum", "dB", "dC"), got, want):
        assert torch.isfinite(g).all(), name
        assert _bwd_within(g, w), name
    if cs == 1:
        assert torch.equal(got[2], torch.zeros_like(got[2]))


@pytest.mark.parametrize("H,G", [(24, 1), (8, 8), (4, 1)], ids=["24/1", "8/8", "4/1"])
@pytest.mark.parametrize("cs", [256, 100, 1])
def test_ssd_bwd_tensor_core_plan_covers_every_pair_once(cs, H, G):
    """In each role, every (head, i tile, j tile <= i tile) of a chunk is
    computed by exactly one block, which walks its group's heads in
    increasing order and deals its partner tiles between its two
    warpgroups (the first never has fewer); the column blocks come first,
    j tile 0 (the most work) first, then the row blocks from the last i
    tile down; at the train shape (4 sequences of 8 chunks) the grid has at
    least 128 blocks."""
    n_tiles = -(-cs // ssd_ops.TILE)
    plan = ssd_ops.bwd_tc_launch_plan(cs, H, G)
    want = sorted((h, i, j) for h in range(H) for i in range(n_tiles) for j in range(i + 1))
    for role in ("column", "row"):
        blocks = [blk for blk in plan if blk.role == role]
        assert len(blocks) == n_tiles * G
        if role == "column":
            got = [(h, i, blk.tile) for blk in blocks for h in blk.heads for i in blk.partners]
        else:
            got = [(h, blk.tile, j) for blk in blocks for h in blk.heads for j in blk.partners]
        assert sorted(got) == want
        for blk in blocks:
            per = H // G
            assert blk.heads == tuple(range(blk.group * per, (blk.group + 1) * per))
            assert list(blk.partners) == sorted(blk.partners)
            assert sorted(blk.warpgroups[0] + blk.warpgroups[1]) == list(blk.partners)
            assert 0 <= len(blk.warpgroups[0]) - len(blk.warpgroups[1]) <= 1
    assert [blk.y for blk in plan] == sorted(blk.y for blk in plan)
    assert [(blk.role, blk.tile) for blk in plan[::G]] == (
        [("column", t) for t in range(n_tiles)] + [("row", t) for t in reversed(range(n_tiles))])
    if (cs, H, G) == (256, 24, 1):
        assert len(plan) * 4 * 8 >= 128


def test_ssd_model_views_meet_tensor_core_layout():
    """The x / B / C views that the mamba2 model hands the intra-chunk step
    in bfloat16 pass the tensor-core route's rule (bases and strides in
    16-byte chunks, chunk <= 256); a slice one element in does not, and
    neither does a chunk of 512."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import Transformer, prefill
    from repro_torch.models import ssm as tssm

    cfg = reduced_config("mamba2-130m").replace(dtype="bfloat16")
    torch.manual_seed(0)
    model = Transformer(cfg, device="cpu")
    seen = []

    def spy(xh, dt, A, Bc, Cc, chunk, initial_state=None):
        def intra(x, dtc, cum, B, C):
            assert x.dtype == B.dtype == C.dtype == torch.bfloat16
            aligned = ssd_ops.meets_tensor_core_layout(x=x, B=B, C=C)
            assert aligned and ssd_ops.route(x.shape[-2], x.shape[-1], B.shape[-1], x.dtype, aligned) == "main"
            seen.append(x.shape)
            return ssd_ops.ssd_chunk_ref(x, dtc, cum, B, C)

        return ssd_ops._chunked(xh, dt, A, Bc, Cc, chunk, initial_state, intra)

    orig = tssm.ssd_chunked
    tssm.ssd_chunked = spy
    try:
        for L in (37, 64):  # a ragged tail (padded copies) and whole chunks (views)
            tokens = torch.from_numpy(np.random.default_rng(L).integers(0, cfg.vocab, (2, L)).astype(np.int32))
            prefill(model, {"tokens": tokens}, cfg)
    finally:
        tssm.ssd_chunked = orig
    assert len(seen) == 2 * cfg.n_layers
    x = torch.zeros(1, 2, 3, 8, 65, dtype=torch.bfloat16)[..., 1:]
    B = torch.zeros(1, 1, 3, 8, 16, dtype=torch.bfloat16)
    assert not ssd_ops.meets_tensor_core_layout(x=x, B=B, C=B)
    assert ssd_ops.route(8, 64, 16, torch.bfloat16, aligned=False) == "wide"
    assert ssd_ops.route(512, 64, 16, torch.bfloat16) == "wide"


# ---------------------------------------------------------------------------
# ssd: the card's route goes through the autograd function
# ---------------------------------------------------------------------------

def _ssd_small_inputs(requires_grad: bool, device="cpu"):
    rng = np.random.default_rng(21)
    x = torch.tensor(rng.standard_normal((1, 2, 1, 8, 8)), dtype=torch.float32, device=device)
    dt = torch.tensor(rng.random((1, 2, 1, 8)), dtype=torch.float32, device=device)
    cum = torch.cumsum(-dt, dim=-1)
    B, C = (torch.tensor(rng.standard_normal((1, 1, 1, 8, 16)), dtype=torch.float32, device=device)
            for _ in range(2))
    return [t.requires_grad_(requires_grad) for t in (x, dt, cum.detach(), B, C)]


def test_ssd_card_route_records_the_autograd_function(monkeypatch):
    """Off the CPU, ``ssd_intra_chunk`` goes through ``SsdIntraChunkFn``
    whether or not autograd records.  Meta tensors (no card needed) take
    the wrappers' meta routes: the forward's outputs carry the Function's
    node as ``grad_fn``, and the backward reaches the backward kernel's
    wrapper, whose meta route gives each input its gradient's shape; with
    the forward launch stubbed, the same.  Under ``torch.no_grad`` nothing
    is recorded.  No launch is counted."""
    before = (ssd_ops.launches.count, ssd_ops.bwd_launches.count)
    ts = _ssd_small_inputs(True, device="meta")
    y, state = ssd_ops.ssd_intra_chunk(*ts)
    assert type(y.grad_fn).__name__ == "SsdIntraChunkFnBackward" and y.device.type == "meta"
    grads = torch.autograd.grad(y.sum() + state.sum(), ts)
    assert [(g.device.type, g.shape) for g in grads] == [("meta", t.shape) for t in ts]
    calls = []

    def stub(x, dt, cum, B, C):
        calls.append(torch.is_grad_enabled())
        return (torch.empty(x.shape, device="meta"),
                torch.empty(x.shape[:3] + (B.shape[-1], x.shape[-1]), device="meta"))

    monkeypatch.setattr(ssd_ops, "_intra_chunk_kernel", stub)
    y, state = ssd_ops.ssd_intra_chunk(*ts)
    assert type(y.grad_fn).__name__ == "SsdIntraChunkFnBackward"
    assert type(state.grad_fn) is type(y.grad_fn)
    grads = torch.autograd.grad(y.sum() + state.sum(), ts)
    assert [(g.device.type, g.shape) for g in grads] == [("meta", t.shape) for t in ts]
    with torch.no_grad():
        y, state = ssd_ops.ssd_intra_chunk(*ts)
    assert y.grad_fn is None and state.grad_fn is None
    assert calls == [False, False]  # the Function's forward runs without recording
    # the CPU route is the differentiable plain version
    y, state = ssd_ops.ssd_intra_chunk(*_ssd_small_inputs(True))
    assert y.requires_grad and state.requires_grad and y.grad_fn is not None
    assert (ssd_ops.launches.count, ssd_ops.bwd_launches.count) == before


def test_ssd_function_backward_is_the_plain_backward_on_the_cpu(monkeypatch):
    """``SsdIntraChunkFn`` wired to the plain forward: its gradients (the
    backward wrapper's CPU route, ``ssd_chunk_bwd_ref``, fed a permuted
    dy) equal autograd of the plain forward, B/C on one group of 2 heads."""
    monkeypatch.setattr(ssd_ops, "_intra_chunk_kernel", ssd_ops.ssd_chunk_ref)
    rng = np.random.default_rng(22)
    dy = torch.from_numpy(rng.standard_normal((1, 1, 8, 2, 8)).astype(np.float32)).permute(0, 3, 1, 2, 4)
    dS = torch.from_numpy(rng.standard_normal((1, 2, 1, 16, 8)).astype(np.float32))
    grads = []
    for fn in (ssd_ops.SsdIntraChunkFn.apply, ssd_ops.ssd_chunk_ref):
        ts = _ssd_small_inputs(True)
        y, state = fn(*ts)
        grads.append(torch.autograd.grad((y * dy).sum() + (state * dS).sum(), ts))
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# decode attention: the launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 70, 256, 2304])
def test_decode_plan_covers_every_valid_slot_once(S):
    rng = np.random.default_rng(S)
    pos = [0, S - 1, S + 40, int(rng.integers(0, S)), 63, 64, 65]
    plan = decode_ops.chunk_plan(pos, S)
    for p, chunks in zip(pos, plan):
        slots = [s for a, b in chunks for s in range(a, b)]
        assert slots == list(range(min(p + 1, S)))
        assert all(a % decode_ops.CHUNK == 0 and 0 < b - a <= decode_ops.CHUNK for a, b in chunks)


def test_decode_work_list_holds_each_chunk_once():
    """Every (sequence, chunk, KV head) of the plan is one item of the
    kernel's work list (one block each); nothing past pos[b]."""
    S, KH = 300, 3
    pos = [299, 0, 130, 1000, -1]
    plan = decode_ops.chunk_plan(pos, S)
    items = decode_ops.work_list(pos, S, KH)
    assert len(set(items)) == len(items)
    want = {(b, c, kh) for b, chunks in enumerate(plan) for c in range(len(chunks)) for kh in range(KH)}
    assert set(items) - {(4, 0, kh) for kh in range(KH)} == want
    assert [b for b, _, _ in items] == sorted(b for b, _, _ in items)


def test_decode_plan_of_a_sequence_ignores_the_others():
    """Sequence b's chunk boundaries are a function of pos[b] and S alone:
    the other entries of pos (empty slots, live ones) do not move them."""
    S = 2304
    alone = decode_ops.chunk_plan([792, 0, 0, 0], S)[0]
    rng = np.random.default_rng(3)
    for _ in range(20):
        others = [int(v) for v in rng.integers(-1, 3000, 3)]
        assert decode_ops.chunk_plan([792] + others, S)[0] == alone
        assert decode_ops.chunk_plan(others + [792], S)[3] == alone


# ---------------------------------------------------------------------------
# dispatch: counters, devices
# ---------------------------------------------------------------------------

def test_cpu_tensors_never_count_as_launches():
    all_ops = (rmsnorm_ops, flash_ops, decode_ops, ssd_ops)
    for ops in all_ops:
        ops.launches.reset()
    x = torch.randn(3, 8)
    rmsnorm_ops.rmsnorm(x, torch.zeros(8))
    q = torch.randn(1, 5, 4, 8)
    flash_ops.flash_attention(q, q, q)
    decode_ops.decode_attention(q[:, :1], q, q, torch.tensor([2], dtype=torch.int32))
    ssd_ops.ssd_chunked(q, torch.rand(1, 5, 4), -torch.ones(4), q, q, chunk=4)
    assert [m.launches.count for m in all_ops] == [0, 0, 0, 0]


def test_cuda_request_without_card_raises():
    if dispatch.cuda_available():
        pytest.skip("a Hopper card is present: cuda is a valid request here")
    from repro_torch.configs import reduced_config
    from repro_torch.models import init_params

    with pytest.raises(RuntimeError, match="no CUDA card"):
        dispatch.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        init_params(reduced_config("deepseek-7b"))  # device defaults to cuda


def test_kernel_sources_are_present():
    names = sorted(p.name for p in dispatch.CSRC.glob("*.cu"))
    assert names == ["decode_attention.cu", "decode_attention_wide.cu", "flash_attention.cu",
                     "flash_attention_bwd.cu", "flash_attention_wide.cu", "rmsnorm.cu", "ssd.cu",
                     "ssd_bwd_wgmma.cu", "ssd_wide.cu"]


# ---------------------------------------------------------------------------
# codelets: the paper's CPU / GPU choice of implementation
# ---------------------------------------------------------------------------

def _codelet_case(name):
    """(codelet, data-slot values, static parameters, plain version)."""
    rng = np.random.default_rng(11)
    f32 = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    if name == "rmsnorm":
        return rmsnorm_ops.rmsnorm_codelet, (f32(4, 128), f32(128)), dict(eps=1e-6), rmsnorm_ops.rmsnorm_ref
    if name == "flash_attention":
        q, k, v = f32(1, 9, 4, 16), f32(1, 9, 2, 16), f32(1, 9, 2, 16)
        return flash_ops.flash_attention_codelet, (q, k, v), dict(window=5), flash_ops.attention_ref
    if name == "decode_attention":
        q, k = f32(2, 1, 4, 16), f32(2, 12, 2, 16)
        pos = torch.tensor([3, 11], dtype=torch.int32)
        return decode_ops.decode_attention_codelet, (q, k, f32(2, 12, 2, 16), pos), {}, decode_ops.decode_attention_ref
    xh, Bc = f32(1, 21, 4, 8), f32(1, 21, 1, 12)
    dt = torch.nn.functional.softplus(f32(1, 21, 4) - 1)
    args = (xh, dt, -torch.ones(4), Bc, f32(1, 21, 1, 12))
    return ssd_ops.ssd_codelet, args, dict(chunk=8), ssd_ops.ssd_chunked_ref


@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention", "decode_attention", "ssd_chunked"])
def test_codelet_registers_cuda_and_ref(name):
    """Each kernel is a Specx codelet with a plain (``ref``) and a device
    (``cuda``) implementation, as ``repro`` registers ``ref`` and ``pallas``
    (``tests/test_codelet.py``); without a card only ``ref`` is available,
    and a run through the port's ``SpRuntime`` gives the plain result."""
    from repro_torch.core import SpData, SpRuntime

    codelet, args, static, plain = _codelet_case(name)
    assert codelet.name == name
    assert codelet.impl_kinds == ["cuda", "ref"]
    want_kinds = ["cuda", "ref"] if dispatch.cuda_available() else ["ref"]
    assert codelet.available_kinds() == want_kinds
    out = SpData(None)
    with SpRuntime(workers=2) as rt:
        codelet(*(SpData(a) for a in args), out, **static)
        rt.wait_all_tasks()
    got, want = out.value, plain(*args, **static)
    for g, w in zip(*(t if isinstance(t, tuple) else (t,) for t in (got, want))):
        assert torch.equal(g, w)
