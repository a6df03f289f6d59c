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


def test_flash_model_qkv_meet_tensor_core_layout():
    """The q / k / v that the model hands the flash kernel in bfloat16 pass
    the tensor-core route's alignment rule; a head slice does not."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import Transformer
    from repro_torch.models.attention import qkv_project

    cfg = reduced_config("deepseek-7b").replace(dtype="bfloat16")
    torch.manual_seed(0)
    model = Transformer(cfg, device="cpu")
    attn = next(m for m in model.modules() if hasattr(m, "wq"))
    x = torch.randn(2, 37, cfg.d_model).to(torch.bfloat16)
    q, k, v = qkv_project(attn, x, torch.arange(37), cfg)
    assert q.dtype == torch.bfloat16 and q.shape == (2, 37, cfg.n_heads, cfg.head_dim)
    flash_ops.check_tensor_core_layout(q=q, k=k, v=v)
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_ops.check_tensor_core_layout(q=q[..., :12])


def test_flash_rejects_nonpositive_window():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, q, q, window=0)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 17, 127, 255])
@pytest.mark.parametrize("B,H,KH,S,D", [(2, 8, 2, 256, 64), (1, 4, 4, 128, 32)])
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
    assert names == ["decode_attention.cu", "flash_attention.cu", "rmsnorm.cu", "ssd.cu"]


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
