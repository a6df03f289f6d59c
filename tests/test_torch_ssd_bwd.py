"""The port's SSD backward against ``repro``'s autodiff, on the CPU.

``repro`` has no Pallas backward for the SSD: it trains through ``jax.grad``
of the jnp ``ssd_chunked``.  The port's card runs hand-written backward
kernels (``csrc/ssd_bwd_wgmma.cu``, ``csrc/ssd_wide.cu``) whose plain
version, ``ssd_chunk_bwd_ref``,
writes the vector-Jacobian product out as formulas.  These tests hold that
plain version, and autograd of the port's ``ssd_chunk_ref``, against
``jax.vjp`` of ``repro.kernels.ssd.ref.ssd_chunk_ref`` and of
``repro.models.ssm.ssd_chunked``; each gradient within 1e-5 of its largest
magnitude (float32).  Inputs come from numpy with a seed.
``test_torch_cuda_kernels.py`` holds the kernel against the plain version
on the card.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssd.ref import ssd_chunk_ref as jax_ssd_chunk_ref  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunk_bwd_ref, ssd_chunk_ref  # noqa: E402

pytestmark = pytest.mark.timeout(300)

GRAD_RTOL = 1e-5  # of each gradient's largest magnitude
NAMES = ("x", "dt", "cum", "B", "C")


def _softplus(a: np.ndarray) -> np.ndarray:
    return np.log1p(np.exp(a)).astype(np.float32)


def _close_scaled(got, want, name: str) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_RTOL * np.abs(want).max() + 1e-30,
                               err_msg=name)


def _chunk_case(cs, H, G, *, b=2, nc=3, P=8, N=12, seed=0, dt_shift=-1.0, decay=0.4):
    """Model-layout chunk inputs (b, H, nc, cs, ·) with B/C on G groups, and
    float32 cotangents of y and of the state."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, H, nc, cs, P)).astype(np.float32)
    dt = _softplus(rng.standard_normal((b, H, nc, cs)) + dt_shift)
    cum = np.cumsum(-dt * decay, axis=-1).astype(np.float32)
    B = rng.standard_normal((b, G, nc, cs, N)).astype(np.float32)
    C = rng.standard_normal((b, G, nc, cs, N)).astype(np.float32)
    dy = rng.standard_normal((b, H, nc, cs, P)).astype(np.float32)
    dS = rng.standard_normal((b, H, nc, N, P)).astype(np.float32)
    return (x, dt, cum, B, C), dy, dS


def _jax_chunk_vjp(arrs, dy, dS):
    """``jax.vjp`` of ``repro``'s one-chunk reference, vmapped over (b, H,
    nc), with B/C repeated over each group's heads; the B/C cotangents are
    summed back over the group (the VJP of the repeat)."""
    x, dt, cum, B, C = arrs
    b, H = x.shape[:2]
    G = B.shape[1]
    rep = lambda a: np.repeat(a, H // G, axis=1)  # noqa: E731
    f = jax.vmap(jax.vmap(jax.vmap(jax_ssd_chunk_ref)))
    _, vjp = jax.vjp(f, *map(jnp.asarray, (x, dt, cum, rep(B), rep(C))))
    g = [np.asarray(t) for t in vjp((jnp.asarray(dy), jnp.asarray(dS)))]
    for k in (3, 4):
        g[k] = g[k].reshape((b, G, H // G) + g[k].shape[2:]).sum(2)
    return g


def _autograd(arrs, dy, dS):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, st = ssd_chunk_ref(*ts)
    return torch.autograd.grad((y * torch.from_numpy(dy)).sum() + (st * torch.from_numpy(dS)).sum(), ts)


@pytest.mark.parametrize("groups", ["one_group", "group_per_head"])
@pytest.mark.parametrize("cs", [8, 16, 64])
def test_ssd_chunk_bwd_matches_jax_vjp(cs, groups):
    """The explicit formulas and autograd of the plain forward, against
    ``jax.vjp`` of ``repro``'s chunk reference: cs 8 / 16 / 64, B/C on one
    group of 4 heads or one group per head."""
    H = 4
    arrs, dy, dS = _chunk_case(cs, H, 1 if groups == "one_group" else H, seed=cs)
    want = _jax_chunk_vjp(arrs, dy, dS)
    got = ssd_chunk_bwd_ref(*map(torch.from_numpy, arrs), torch.from_numpy(dy), torch.from_numpy(dS))
    auto = _autograd(arrs, dy, dS)
    for name, g, a, w, inp in zip(NAMES, got, auto, want, arrs):
        assert tuple(g.shape) == inp.shape and g.dtype == torch.float32
        _close_scaled(g, w, f"formulas d{name}")
        _close_scaled(a, w, f"autograd d{name}")


def test_ssd_chunk_bwd_keeps_the_input_dtype():
    """bfloat16 x / B / C get bfloat16 gradients (float32 sums, rounded
    once); dt and cum stay float32."""
    arrs, dy, dS = _chunk_case(16, 4, 1, seed=3)
    ts = [torch.from_numpy(a) for a in arrs]
    for k in (0, 3, 4):
        ts[k] = ts[k].bfloat16()
    got = ssd_chunk_bwd_ref(*ts, torch.from_numpy(dy), torch.from_numpy(dS))
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16, torch.bfloat16]
    want = ssd_chunk_bwd_ref(*(t.float() for t in ts), torch.from_numpy(dy), torch.from_numpy(dS))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.to(g.dtype).float(), rtol=0, atol=0)


def test_ssd_plain_gradient_finite_under_strong_decay(record_property):
    """A chunk of 64 whose decay spans more than 88 (cum_0 − cum_63 > 100):
    exp of the masked triangle overflows.  Every gradient of the port's
    plain version (formulas and autograd) is finite and the two agree.
    ``repro``'s reference, which exponentiates before it masks, is recorded
    (its d cum is NaN at the time of writing) but not relied on."""
    arrs, dy, dS = _chunk_case(64, 2, 1, seed=7, dt_shift=-0.5, decay=8.0)
    cum = arrs[2]
    assert float((cum[..., 0] - cum[..., -1]).max()) > 100
    got = ssd_chunk_bwd_ref(*map(torch.from_numpy, arrs), torch.from_numpy(dy), torch.from_numpy(dS))
    auto = _autograd(arrs, dy, dS)
    for name, g, a in zip(NAMES, got, auto):
        assert torch.isfinite(g).all() and torch.isfinite(a).all(), name
        _close_scaled(g, a.numpy(), f"d{name}")
    want = _jax_chunk_vjp(arrs, dy, dS)
    record_property("repro_finite_grads", {n: bool(np.isfinite(w).all()) for n, w in zip(NAMES, want)})
    for name, g, w in zip(NAMES, got, want):  # where repro's is finite, the two agree
        if np.isfinite(w).all():
            _close_scaled(g, w, f"d{name} against repro")


def _scan_case(Bm, L, H, P, N, G, seed):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((Bm, L, H, P)).astype(np.float32)
    dt = _softplus(rng.standard_normal((Bm, L, H)) - 1)
    A = (-np.exp(rng.standard_normal(H) * 0.2)).astype(np.float32)
    Bg = rng.standard_normal((Bm, L, G, N)).astype(np.float32)
    Cg = rng.standard_normal((Bm, L, G, N)).astype(np.float32)
    s0 = rng.standard_normal((Bm, H, N, P)).astype(np.float32)
    dy = rng.standard_normal((Bm, L, H, P)).astype(np.float32)
    ds = rng.standard_normal((Bm, H, N, P)).astype(np.float32)
    return (xh, dt, A, Bg, Cg, s0), dy, ds


@pytest.mark.parametrize("route", ["autograd", "function"])
@pytest.mark.parametrize("groups", ["one_group", "group_per_head"])
@pytest.mark.parametrize("L,chunk", [(77, 16), (64, 8)], ids=["ragged", "whole_chunks"])
def test_ssd_chunked_grads_match_repro(L, chunk, groups, route, monkeypatch):
    """Gradients of the whole scan (x, dt, A, B, C and the initial state)
    against ``jax.vjp`` of ``repro.models.ssm.ssd_chunked`` (B/C repeated
    over heads there, read by group in the port): L = 77 in chunks of 16
    (a padded 13-row tail) and L = 64 in chunks of 8.  ``autograd``
    differentiates the plain forward; ``function`` runs the card's route,
    :class:`SsdIntraChunkFn`, with its forward launch swapped for the
    plain forward, so the backward is ``ssd_chunk_bwd_ref`` as the card's
    wrapper calls it."""
    Bm, H, P, N = 2, 4, 8, 12
    G = 1 if groups == "one_group" else H
    leaves, dy, ds = _scan_case(Bm, L, H, P, N, G, seed=L + G)
    xh, dt, A, Bg, Cg, s0 = leaves
    rep = lambda a: np.repeat(a, H // G, axis=2)  # noqa: E731

    def jax_scan(xh, dt, A, Bg, Cg, s0):
        return jax_ssm.ssd_chunked(xh, dt, A, jnp.repeat(Bg, H // G, axis=2),
                                   jnp.repeat(Cg, H // G, axis=2), chunk, s0)

    _, vjp = jax.vjp(jax_scan, *map(jnp.asarray, leaves))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    assert rep(Bg).shape == (Bm, L, H, N)
    ts = [torch.from_numpy(a).requires_grad_() for a in leaves]
    if route == "function":
        monkeypatch.setattr(ssd_ops, "_intra_chunk_kernel", ssd_chunk_ref)
        y, s = ssd_ops._chunked(*ts[:5], chunk, ts[5], ssd_ops.SsdIntraChunkFn.apply)
    else:
        y, s = ssd_ops.ssd_chunked(*ts[:5], chunk, ts[5])
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + (s * torch.from_numpy(ds)).sum(), ts)
    for name, g, w in zip(("xh", "dt", "A", "B", "C", "s0"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        _close_scaled(g, w, f"d{name}")


def test_ssd_chunk_bwd_padded_rows_get_no_gradient():
    """The ragged tail as ``ssd_chunked`` pads it (x, B, C zero and dt = 0,
    so cum is flat there) with y's cotangent zero on the dropped rows:
    dx, ddt, dB and dC of the padded rows are zero."""
    arrs, dy, dS = _chunk_case(16, 4, 1, seed=11)
    x, dt, cum, B, C = (a.copy() for a in arrs)
    pad = slice(10, None)
    for t in (x, B, C):
        t[..., pad, :] = 0
    dt[..., pad] = 0
    cum[..., pad] = cum[..., 9:10]
    dy[..., pad, :] = 0
    got = ssd_chunk_bwd_ref(*map(torch.from_numpy, (x, dt, cum, B, C)), torch.from_numpy(dy),
                            torch.from_numpy(dS))
    for name, g in zip(NAMES, got):
        if name != "cum":
            rows = g[..., pad, :] if g.ndim == 5 else g[..., pad]
            assert torch.count_nonzero(rows) == 0, name
