"""The port's Mamba-2 path against ``repro``'s, with the same inputs and weights.

On the CPU the SSD wrapper takes its plain PyTorch version.  These tests hold
it against ``repro``'s Pallas kernel in interpret mode and ``ref.py`` over
``tests/test_kernels.py``'s sweep; the port's chunked scan against
``repro.models.ssm.ssd_chunked`` (ragged L, initial state, groups read in
place) and the naive recurrence; the reduced mamba2 model (prefill logits,
``state`` / ``conv`` caches, decode steps) and ``ServeEngine`` against
``repro``'s.  Inputs come from numpy with a seed; weights cross by
``bridge.params_from_numpy``.  ``test_torch_cuda_kernels.py`` holds the CUDA
kernel against the plain version on the card.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.kernels.ssd.kernel import ssd_intra_chunk_pallas  # noqa: E402
from repro.kernels.ssd.ref import ssd_chunk_ref as jax_ssd_chunk_ref  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.runtime.serve import prime_cache as jax_prime_cache  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.param import ParamDef, init_  # noqa: E402
from repro_torch.runtime.serve import prime_cache  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402

pytestmark = pytest.mark.timeout(300)

KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_kernels.py::test_ssd_intra_chunk
NAIVE_TOL = dict(rtol=1e-3, atol=1e-3)   # ::test_ssd_full_pipeline_vs_naive_recurrence
TOL = dict(rtol=1e-4, atol=1e-4)         # test_torch_model.py's


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol) -> None:
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _softplus(a: np.ndarray) -> np.ndarray:
    return np.log1p(np.exp(a)).astype(np.float32)


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------

def _chunk_inputs(cs, P, N, *, BH=3, nc=4, seed=2, dt_shift=-1.0, decay=0.4):
    """``test_ssd_intra_chunk``'s inputs, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BH, nc, cs, P)).astype(np.float32)
    dt = _softplus(rng.standard_normal((BH, nc, cs)) + dt_shift)
    cum = np.cumsum(-dt * decay, axis=2).astype(np.float32)
    B = rng.standard_normal((BH, nc, cs, N)).astype(np.float32)
    C = rng.standard_normal((BH, nc, cs, N)).astype(np.float32)
    return x, dt, cum, B, C


@pytest.mark.parametrize("cs,P,N", [(16, 8, 12), (32, 16, 16), (64, 64, 128)])
def test_ssd_plain_matches_pallas_and_ref(cs, P, N):
    arrs = _chunk_inputs(cs, P, N)
    jy, jst = ssd_intra_chunk_pallas(*map(jnp.asarray, arrs), interpret=True)
    ty, tst = ssd_ops.ssd_intra_chunk(*map(torch.from_numpy, arrs))
    assert tuple(ty.shape) == tuple(jy.shape) and tuple(tst.shape) == tuple(jst.shape)
    assert ty.dtype == tst.dtype == torch.float32
    _close(ty, jy, KERNEL_TOL)
    _close(tst, jst, KERNEL_TOL)
    x, dt, cum, B, C = arrs
    for b, c in ((0, 0), (2, 3)):
        y0, st0 = jax_ssd_chunk_ref(x[b, c], dt[b, c], cum[b, c], B[b, c], C[b, c])
        _close(ty[b, c], y0, KERNEL_TOL)
        _close(tst[b, c], st0, KERNEL_TOL)


def test_ssd_plain_strong_decay_stays_finite():
    """cum_i − cum_j passes 100 inside a chunk, so exp of the masked triangle
    is inf: the select keeps it out (a 0/1 multiply would give NaN)."""
    arrs = _chunk_inputs(64, 16, 16, dt_shift=3.0, decay=1.0)
    cum = arrs[2]
    assert float((cum[..., 0] - cum[..., -1]).max()) > 100
    ty, tst = ssd_ops.ssd_intra_chunk(*map(torch.from_numpy, arrs))
    assert torch.isfinite(ty).all() and torch.isfinite(tst).all()
    jy, jst = ssd_intra_chunk_pallas(*map(jnp.asarray, arrs), interpret=True)
    _close(ty, jy, KERNEL_TOL)
    _close(tst, jst, KERNEL_TOL)


def test_ssd_plain_reads_groups_as_expanded_heads():
    """(batch, H) leading dims with B/C on G = 2 groups: head h reads group
    h // (H // G), the same as B/C repeated across heads."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 4, 3, 8, 6)).astype(np.float32))
    dt = torch.from_numpy(_softplus(rng.standard_normal((2, 4, 3, 8)) - 1))
    cum = torch.cumsum(-dt * 0.4, dim=-1)
    B, C = (torch.from_numpy(rng.standard_normal((2, 2, 3, 8, 5)).astype(np.float32)) for _ in range(2))
    got = ssd_ops.ssd_intra_chunk(x, dt, cum, B, C)
    rep = lambda t: torch.repeat_interleave(t, 2, dim=1)  # noqa: E731
    want = ssd_ops.ssd_intra_chunk(x, dt, cum, rep(B), rep(C))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# the chunked scan
# ---------------------------------------------------------------------------

def _scan_inputs(Bm, L, H, P, N, seed):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((Bm, L, H, P)).astype(np.float32)
    dt = _softplus(rng.standard_normal((Bm, L, H)) - 1)
    A = (-np.exp(rng.standard_normal(H) * 0.2)).astype(np.float32)
    Bg = rng.standard_normal((Bm, L, 1, N)).astype(np.float32)
    Cg = rng.standard_normal((Bm, L, 1, N)).astype(np.float32)
    return xh, dt, A, Bg, Cg


@pytest.mark.parametrize("with_init", [False, True], ids=["zero_state", "initial_state"])
@pytest.mark.parametrize("groups", [False, True], ids=["heads", "one_group"])
def test_ssd_chunked_ragged_matches_repro(with_init, groups):
    """L = 77 with chunk 16 (a 13-row tail); B/C given per head, or as one
    group that the port reads in place and ``repro`` gets expanded."""
    Bm, L, H, P, N = 2, 77, 4, 8, 12
    xh, dt, A, Bg, Cg = _scan_inputs(Bm, L, H, P, N, seed=3)
    Bh, Ch = (np.repeat(t, H, axis=2) for t in (Bg, Cg))
    s0 = np.random.default_rng(4).standard_normal((Bm, H, N, P)).astype(np.float32) if with_init else None
    jy, js = jax_ssm.ssd_chunked(
        *map(jnp.asarray, (xh, dt, A, Bh, Ch)), 16, None if s0 is None else jnp.asarray(s0)
    )
    Bp, Cp = (Bg, Cg) if groups else (Bh, Ch)
    ty, ts = ssd_ops.ssd_chunked(
        *map(torch.from_numpy, (xh, dt, A, Bp, Cp)), 16, None if s0 is None else torch.from_numpy(s0)
    )
    assert tuple(ty.shape) == (Bm, L, H, P) and tuple(ts.shape) == (Bm, H, N, P)
    _close(ty, jy, TOL)
    _close(ts, js, TOL)


def test_ssd_chunked_matches_naive_recurrence():
    """``test_ssd_full_pipeline_vs_naive_recurrence``'s shapes; the port's
    naive oracle equals ``repro``'s."""
    Bm, L, H, P, N = 2, 64, 4, 8, 12
    xh, dt, A, Bg, Cg = _scan_inputs(Bm, L, H, P, N, seed=6)
    Bh, Ch = (np.repeat(t, H, axis=2) for t in (Bg, Cg))
    jy, js = jax_ssm.ssd_naive(*map(jnp.asarray, (xh, dt, A, Bh, Ch)))
    targs = tuple(map(torch.from_numpy, (xh, dt, A, Bh, Ch)))
    ty, ts = ssd_ops.ssd_chunked(*targs, chunk=16)
    _close(ty, jy, NAIVE_TOL)
    _close(ts, js, NAIVE_TOL)
    ny, ns = tssm.ssd_naive(*targs)
    _close(ny, jy, TOL)
    _close(ns, js, TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba():
    jcfg = jax_reduced_config("mamba2-130m").replace(dtype="float32")
    cfg = reduced_config("mamba2-130m").replace(dtype="float32")
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, model


def test_port_config_copy_matches_repro():
    assert repr(jax_reduced_config("mamba2-130m")) == repr(reduced_config("mamba2-130m"))
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    assert repr(jax_get_config("mamba2-130m")) == repr(get_config("mamba2-130m"))


@pytest.mark.parametrize("L", [1, 13, 16], ids=["one_token", "ragged_tail", "two_chunks"])
def test_prefill_logits_and_caches_match(mamba, L):
    """chunk_size 8: L = 13 runs a padded 5-row tail, L = 1 a chunk of one."""
    jcfg, jparams, cfg, model = mamba
    toks = np.random.default_rng(L).integers(0, cfg.vocab, size=(2, L)).astype(np.int32)
    jl, jc = jax_prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = tm.prefill(model, {"tokens": torch.from_numpy(toks)}, cfg)
    assert tuple(tl.shape) == tuple(jl.shape)
    _close(tl, jl, TOL)
    assert set(tc) == {"state", "conv"} and tc["state"].dtype == torch.float32
    for k in ("state", "conv"):
        assert tuple(tc[k].shape) == tuple(jc[k].shape)
        _close(tc[k], jc[k], TOL)
    # ssm states are decode-ready: priming passes them through
    primed = prime_cache(cfg, tc, L, 32)
    assert all(primed[k] is tc[k] for k in tc)


def test_decode_steps_match(mamba):
    """Two sequences of different lengths decode together for four steps,
    fed the same (JAX-greedy) tokens; the caches are updated in place."""
    jcfg, jparams, cfg, model = mamba
    rng = np.random.default_rng(1)
    lens, max_seq = (7, 11), 24
    jcaches, tcaches, first = [], [], []
    for L in lens:
        toks = rng.integers(0, cfg.vocab, size=(1, L)).astype(np.int32)
        jl, jc = jax_prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
        _, tc = tm.prefill(model, {"tokens": torch.from_numpy(toks)}, cfg)
        jcaches.append(jax_prime_cache(jcfg, jc, L, max_seq))
        tcaches.append(prime_cache(cfg, tc, L, max_seq))
        first.append(int(jnp.argmax(jl[0, -1])))
    jcache = {k: jnp.concatenate([c[k] for c in jcaches], axis=1) for k in ("state", "conv")}
    tcache = {k: torch.cat([c[k] for c in tcaches], dim=1) for k in ("state", "conv")}
    ptrs = {k: v.data_ptr() for k, v in tcache.items()}
    tok = np.asarray(first, np.int32)[:, None]
    for step in range(4):
        pos = np.asarray([L + step for L in lens], np.int32)
        jl, jcache = jax_decode_step(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos), jcfg)
        tl, tout = tm.decode_step(model, torch.from_numpy(tok), tcache, torch.from_numpy(pos), cfg)
        assert tout is tcache and {k: v.data_ptr() for k, v in tout.items()} == ptrs
        _close(tl, jl, TOL)
        tok = np.array(jnp.argmax(jl[:, 0], axis=-1), np.int32)[:, None]
    for k in ("state", "conv"):
        _close(tcache[k], jcache[k], TOL)


def test_ssm_apply_matches_repro(mamba):
    """One mixer alone, on a ragged length, with its cache."""
    jcfg, jparams, cfg, model = mamba
    x = np.random.default_rng(8).standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda t: t[1], jparams["layers"]["ssm"])
    jy, jc = jax_ssm.ssm_apply(jp, jnp.asarray(x), jcfg, want_cache=True)
    ty, tc = tssm.ssm_apply(model.layers[1].ssm, torch.from_numpy(x), cfg, want_cache=True)
    _close(ty, jy, TOL)
    for k in ("state", "conv"):
        _close(tc[k], jc[k], TOL)


def test_cache_defs_match_repro():
    for dtype in ("float32", "bfloat16"):
        jcfg = jax_reduced_config("mamba2-130m").replace(dtype=dtype)
        cfg = reduced_config("mamba2-130m").replace(dtype=dtype)
        jc = jax_init_cache(jcfg, 3, 16)
        tc = tm.init_cache(cfg, 3, 16, device="cpu")
        assert set(tc) == set(jc)
        for k in jc:
            assert tuple(tc[k].shape) == tuple(jc[k].shape)
            assert str(tc[k].dtype).removeprefix("torch.") == str(jc[k].dtype)
        assert tm.cache_layout(cfg) is None


def test_init_rules_ones_and_const_follow_repro():
    """``A_log`` and ``D`` are ``ones``, ``dt_bias`` is ``const`` −4.0, as in
    ``repro``'s ``init_tree``; ``const`` fills with ``scale``."""
    jcfg = jax_reduced_config("mamba2-130m")
    jssm = jax_init_params(jax.random.PRNGKey(1), jcfg)["layers"]["ssm"]
    model = tm.init_params(reduced_config("mamba2-130m"), 1, device="cpu")
    for layer in (0, 1):
        m = model.layers[layer].ssm
        for key in ("A_log", "D", "dt_bias", "conv_b", "norm"):
            want = np.asarray(jssm[key][layer], np.float32)
            np.testing.assert_array_equal(_np(getattr(m, key)), want)
    gen = torch.Generator().manual_seed(0)
    t = torch.empty(3)
    init_(t, ParamDef((3,), (None,), init="const", scale=2.5), gen)
    assert t.tolist() == [2.5] * 3
    init_(t, ParamDef((3,), (None,), init="ones"), gen)
    assert t.tolist() == [1.0] * 3


def test_bridge_fills_and_checks_ssm_leaves(mamba):
    jcfg, jparams, cfg, model = mamba
    tree = jax.tree.map(np.asarray, jparams)
    assert np.array_equal(_np(model.layers[1].ssm.norm), tree["layers"]["ssm"]["norm"][1])
    assert np.array_equal(_np(model.layers[0].ln1.scale), tree["layers"]["ln1"][0])
    bad = jax.tree.map(np.asarray, jparams)
    bad["layers"]["ssm"]["D"] = bad["layers"]["ssm"]["D"][:, :-1]
    with pytest.raises(ValueError, match="D"):
        params_from_numpy(bad, cfg, device="cpu")
    missing = jax.tree.map(np.asarray, jparams)
    del missing["layers"]["ssm"]["conv_w"]
    with pytest.raises(ValueError, match="conv_w"):
        params_from_numpy(missing, cfg, device="cpu")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _sequential(model, cfg, prompt, n):
    logits, caches = tm.prefill(model, {"tokens": torch.from_numpy(prompt[None, :])}, cfg)
    caches = prime_cache(cfg, caches, len(prompt), 32)
    toks = [int(torch.argmax(logits[0, -1]))]
    for s in range(n - 1):
        t = torch.tensor([[toks[-1]]], dtype=torch.int32)
        logits, caches = tm.decode_step(model, t, caches, len(prompt) + s, cfg)
        toks.append(int(torch.argmax(logits[0, 0])))
    return toks


def test_serving_matches_repro_and_sequential_loop(mamba):
    """Staggered prompts and a duplicate: the ssm caches are not pageable, so
    the duplicate re-prefills (no restore) and gives the same stream."""
    jcfg, jparams, cfg, model = mamba
    prompts = _prompts(0, (5, 9, 7), cfg.vocab)
    streams = []
    engines = (JaxServeEngine(jcfg, jparams, n_slots=4, max_seq=32, block_size=4),
               ServeEngine(cfg, model, n_slots=4, max_seq=32, block_size=4, device="cpu"))
    for eng in engines:
        with eng:
            reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
            eng.run_until_drained(max_iters=50)
            dup = eng.submit(prompts[0], max_new_tokens=6)
            eng.run_until_drained(max_iters=50)
            assert all(r.done for r in reqs + [dup])
            assert dup.out_tokens == reqs[0].out_tokens
            stats = eng.stats()
            assert (stats["prefills"], stats["restores"], stats["pageable"]) == (4, 0, False)
            streams.append([r.out_tokens for r in reqs])
    assert streams[1] == streams[0]
    for p, toks in zip(prompts, streams[1]):
        assert toks == _sequential(model, cfg, p, 6)


def test_installed_slot_caches_match_repro_prefill(mamba):
    """One slot, two requests in turn: after the second one's admission step
    the slot's ``state`` / ``conv`` are its prefill caches, not what the first
    request's decode steps left there."""
    jcfg, jparams, cfg, model = mamba
    first, second = _prompts(2, (6, 11), cfg.vocab)
    with ServeEngine(cfg, model, n_slots=1, max_seq=32, block_size=4, device="cpu") as eng:
        eng.submit(first, 5)
        eng.run_until_drained()
        eng.submit(second, 5)
        eng.step()  # admission only: prefill + install into slot 0
        _, jc = jax_prefill(jparams, {"tokens": jnp.asarray(second[None, :])}, jcfg)
        for k in ("state", "conv"):
            _close(eng._caches[k][:, 0], np.asarray(jc[k])[:, 0], TOL)
        eng.run_until_drained()


def test_preempted_ssm_request_resumes_by_prefill(mamba):
    """Pool pressure preempts a sequence; with no pageable rows it resumes
    by re-prefilling prompt + generated tokens, and streams stay ``repro``'s."""
    jcfg, jparams, cfg, model = mamba
    p1, p2 = _prompts(7, (5, 5), cfg.vocab)
    streams = []
    kw = dict(n_slots=2, max_seq=16, block_size=4, n_blocks=4)
    for eng in (JaxServeEngine(jcfg, jparams, **kw), ServeEngine(cfg, model, device="cpu", **kw)):
        with eng:
            r1, r2 = eng.submit(p1, 8), eng.submit(p2, 8)
            eng.run_until_drained(max_iters=200)
            assert r1.done and r2.done
            assert eng.scheduler.preemptions >= 1
            assert eng.restores == 0 and eng.prefills == 2 + eng.scheduler.preemptions
            streams.append((r1.out_tokens, r2.out_tokens))
    assert streams[1] == streams[0]
    assert list(streams[1][0]) == _sequential(model, cfg, p1, 8)


def test_launch_serve_mamba2_cpu():
    from repro_torch.launch.serve import main

    out = main(["--arch", "mamba2-130m", "--reduced", "--device", "cpu",
                "--requests", "3", "--slots", "2", "--gen", "4"])
    assert out["stats"]["prefills"] == 3 and out["stats"]["restores"] == 0
    assert out["tok_per_s"] > 0
