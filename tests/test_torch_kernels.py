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


# ---------------------------------------------------------------------------
# dispatch: counters, devices
# ---------------------------------------------------------------------------

def test_cpu_tensors_never_count_as_launches():
    for ops in (rmsnorm_ops, flash_ops, decode_ops):
        ops.launches.reset()
    x = torch.randn(3, 8)
    rmsnorm_ops.rmsnorm(x, torch.zeros(8))
    q = torch.randn(1, 5, 4, 8)
    flash_ops.flash_attention(q, q, q)
    decode_ops.decode_attention(q[:, :1], q, q, torch.tensor([2], dtype=torch.int32))
    assert [m.launches.count for m in (rmsnorm_ops, flash_ops, decode_ops)] == [0, 0, 0]


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
    assert names == ["decode_attention.cu", "flash_attention.cu", "rmsnorm.cu"]
