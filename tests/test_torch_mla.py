"""The port's multi-head latent attention (minicpm3-4b) against ``repro``'s.

``repro`` draws the weights (``jax.random``); ``repro_torch.bridge`` carries
them across.  Inputs are drawn with numpy from a seed.  Everything runs in
float32 on the CPU, where the port's kernels are their plain versions (the
flash kernel's at query / key head dim nope + rope ≠ value head dim).
Tolerances, stated per check: hidden states, logits and caches within
rtol / atol 1e-4 (``test_torch_model.py``'s: the frameworks' CPU matrix
products sum in different orders); the loss within 1e-5 relative; each
gradient within 1e-4 of its leaf's largest magnitude; train-step
parameters as ``test_torch_train.py`` holds Adafactor's (1e-6).  Greedy
token streams are equal.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.data import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models.config import ShapeSpec as JaxShape  # noqa: E402
from repro.runtime.serve import prime_cache as jax_prime_cache  # noqa: E402
from repro.runtime.train import build_train_step as jax_build_train_step  # noqa: E402
from repro.runtime.train import init_train_state as jax_init_train_state  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.bridge import params_from_numpy, train_state_from_numpy, train_state_to_numpy  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.optim import leaf_path  # noqa: E402
from repro_torch.runtime.serve import prime_cache  # noqa: E402
from repro_torch.runtime.train import build_train_step  # noqa: E402
from repro_torch.serving import ServeEngine, shrunken_draft  # noqa: E402

pytestmark = pytest.mark.timeout(300)

ARCH = "minicpm3-4b"
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol=TOL, msg="") -> None:
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


def _tree_leaves(tree: dict) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf in flat}


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_reduced_config(ARCH).replace(dtype="float32")
    cfg = reduced_config(ARCH).replace(dtype="float32")
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    # the norm offsets are zero-initialised: make them matter
    for name in ("q_norm", "kv_norm"):
        leaf = jparams["layers"]["attn"][name]
        jparams["layers"]["attn"][name] = 0.3 * jax.random.normal(jax.random.PRNGKey(7), leaf.shape)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, model


def test_config_copy_matches_repro():
    assert repr(jax_reduced_config(ARCH)) == repr(reduced_config(ARCH))
    assert tm.block_kind(reduced_config(ARCH)) == "mla"


def test_mla_layer_apply_and_decode_match_repro(pair):
    """One MLA layer: the prefill output and latent caches, then three
    absorbed decode steps (at two positions per step) against ``repro``'s."""
    jcfg, jparams, cfg, model = pair
    jp = jax.tree.map(lambda t: t[0], jparams["layers"]["attn"])
    p = model.layers[0].attn
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    jy, jc = jax_mla.mla_apply(jp, jnp.asarray(x), jnp.asarray(pos), jcfg, want_cache=True)
    ty, tc = tmla.mla_apply(p, torch.from_numpy(x), torch.from_numpy(pos.copy()), cfg, want_cache=True)
    _close(ty, jy, msg="prefill out")
    for k in ("c_kv", "k_rope"):
        _close(tc[k], jc[k], msg=k)
    S = 16
    jcache = {k: jnp.zeros((2, S, v.shape[-1]), jnp.float32).at[:, :11].set(v) for k, v in jc.items()}
    tcache = {k: torch.zeros((2, S, v.shape[-1])) for k, v in tc.items()}
    for k in tcache:
        tcache[k][:, :11] = tc[k]
    for step in range(3):
        xs = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        at = np.asarray([11 + step, 9 + step], np.int32)  # the second rewrites written rows
        jy, jcache = jax_mla.mla_decode_step(jp, jnp.asarray(xs), jcache, jnp.asarray(at), jcfg)
        ty, tcache = tmla.mla_decode_step(p, torch.from_numpy(xs), tcache, torch.from_numpy(at), cfg)
        _close(ty, jy, msg=f"decode {step}")
    for k in tcache:
        _close(tcache[k], jcache[k], msg=k)


def test_forward_prefill_and_primed_caches_match_repro(pair):
    jcfg, jparams, cfg, model = pair
    toks = np.random.default_rng(2).integers(0, cfg.vocab, size=(2, 13)).astype(np.int32)
    jx, _, _ = jax_forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    tx, _, aux = tm.forward(model, {"tokens": torch.from_numpy(toks)}, cfg)
    assert aux == {}
    _close(tx, jx, msg="hidden")
    jl, jc = jax_prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = tm.prefill(model, {"tokens": torch.from_numpy(toks)}, cfg)
    _close(tl, jl, msg="logits")
    jp, tp = jax_prime_cache(jcfg, jc, 13, 24), prime_cache(cfg, tc, 13, 24)
    assert set(tp) == {"c_kv", "k_rope"} == set(jp)
    for k in tp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape) == (cfg.n_layers, 2, 24, tc[k].shape[-1])
        _close(tp[k], jp[k], msg=k)
    assert tm.cache_layout(cfg) == {"c_kv": (1, 2), "k_rope": (1, 2)}


def test_decode_steps_per_slot_positions_match_repro(pair):
    """Two sequences at different positions decode together for five steps,
    fed the same (JAX-greedy) tokens; then the caches."""
    jcfg, jparams, cfg, model = pair
    rng = np.random.default_rng(3)
    lens, max_seq = (7, 12), 24
    jcs, tcs, first = [], [], []
    for L in lens:
        toks = rng.integers(0, cfg.vocab, size=(1, L)).astype(np.int32)
        jl, jc = jax_prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
        _, tc = tm.prefill(model, {"tokens": torch.from_numpy(toks)}, cfg)
        jcs.append(jax_prime_cache(jcfg, jc, L, max_seq))
        tcs.append(prime_cache(cfg, tc, L, max_seq))
        first.append(int(jnp.argmax(jl[0, -1])))
    jcache = {k: jnp.concatenate([c[k] for c in jcs], axis=1) for k in jcs[0]}
    tcache = {k: torch.cat([c[k] for c in tcs], dim=1) for k in tcs[0]}
    tok = np.asarray(first, np.int32)[:, None]
    for step in range(5):
        pos = np.asarray([L + step for L in lens], np.int32)
        jl, jcache = jax_decode_step(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos), jcfg)
        tl, tcache = tm.decode_step(model, torch.from_numpy(tok), tcache, torch.from_numpy(pos), cfg)
        _close(tl, jl, msg=f"step {step}")
        tok = np.array(jnp.argmax(jl[:, 0], axis=-1), np.int32)[:, None]
    for k in tcache:
        _close(tcache[k], jcache[k], msg=k)


def test_loss_and_grads_match_repro(pair):
    """The loss within 1e-5 relative and every gradient within 1e-4 of its
    leaf's largest magnitude against ``jax.value_and_grad``."""
    jcfg, jparams, cfg, _ = pair
    model = tm.set_trainable(params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    toks = np.random.default_rng(4).integers(0, cfg.vocab, size=(2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg), has_aux=True)(jparams)
    loss, metrics = tm.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    assert set(metrics) == {"ce_loss"}
    names, tensors = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, tensors)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = _tree_leaves(jgrads)
    for n, g in zip(names, grads):
        path, layer = leaf_path(n)
        w = want[path] if layer is None else want[path][layer]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-12, err_msg=n)


def test_two_adafactor_steps_match_repro():
    """Two staged train steps (2 microbatches) from bridged state: loss and
    grad norm within 1e-4 relative, parameters within 1e-6, optimizer state
    within 1e-5 of each leaf's largest magnitude (``test_torch_train.py``'s
    limits)."""
    jcfg = jax_reduced_config(ARCH).replace(dtype="float32", optimizer="adafactor")
    cfg = reduced_config(ARCH).replace(dtype="float32", optimizer="adafactor")
    js = jax_init_train_state(jax.random.PRNGKey(0), jcfg)
    st = train_state_from_numpy(jax.tree.map(np.asarray, js.params), jax.tree.map(np.asarray, js.opt),
                                js.step, cfg, "cpu")
    jart = jax_build_train_step(jcfg, n_microbatches=2, donate=False)
    art = build_train_step(cfg, n_microbatches=2)
    ds = JaxDataset(jcfg, JaxShape("t", "train", 32, 4), seed=0)
    for step in range(2):
        b = ds.batch_for_step(step)
        js, jm = jart(js, {k: jnp.asarray(v) for k, v in b.items()})
        st, m = art(st, {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("loss", "ce_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=f"{key} {step}")
    p_tree, o_tree, n = train_state_to_numpy(st)
    assert n == 2
    want_p, got_p = _tree_leaves(jax.tree.map(np.asarray, js.params)), _tree_leaves(p_tree)
    assert sorted(want_p) == sorted(got_p)
    for k, w in want_p.items():
        np.testing.assert_allclose(got_p[k], w, rtol=0, atol=1e-6, err_msg=k)
    want_o, got_o = _tree_leaves(jax.tree.map(np.asarray, js.opt)), _tree_leaves(o_tree)
    assert sorted(want_o) == sorted(got_o)
    for k, w in want_o.items():
        np.testing.assert_allclose(got_o[k], w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _engines(pair, **kw):
    jcfg, jparams, cfg, model = pair
    return JaxServeEngine(jcfg, jparams, **kw), ServeEngine(cfg, model, device="cpu", **kw)


def test_engine_streams_prefix_share_and_restore_match_repro(pair):
    """Staggered greedy prompts, then a duplicate that shares the first
    prompt's full blocks (prefix hit, latent rows restored from payloads)
    and one that restores without a prefill: the same streams and
    admission counts as ``repro``'s engine."""
    jcfg, jparams, cfg, model = pair
    prompts = _prompts(5, (5, 9, 13), cfg.vocab)
    out = []
    for eng in _engines(pair, n_slots=3, max_seq=32, block_size=4):
        with eng:
            reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
            eng.run_until_drained(max_iters=60)
            again = [eng.submit(prompts[2], 6), eng.submit(prompts[1], 6)]
            eng.run_until_drained(max_iters=60)
            assert all(r.done for r in reqs + again)
            assert again[0].out_tokens == reqs[2].out_tokens
            assert again[1].out_tokens == reqs[1].out_tokens
            out.append(([r.out_tokens for r in reqs + again], eng.prefills, eng.restores,
                        eng.pool.stats()["shared_hits"]))
    assert out[1] == out[0]
    assert out[1][2] >= 1, "no admission took the restore path"


def test_speculative_streams_equal_the_plain_engine(pair):
    """The latent rows go through speculation too: greedy streams with the
    1-layer shrunken draft at k = 3 equal the plain engine's."""
    _, _, cfg, model = pair
    prompts = _prompts(6, (6, 10), cfg.vocab)
    streams = []
    draft_cfg, draft = shrunken_draft(cfg, model, n_layers=1)
    for kw in ({}, dict(draft_cfg=draft_cfg, draft_params=draft, draft_k=3)):
        with ServeEngine(cfg, model, n_slots=2, max_seq=32, block_size=4, device="cpu", **kw) as eng:
            reqs = [eng.submit(p, max_new_tokens=7) for p in prompts]
            eng.run_until_drained(max_iters=80)
            streams.append([r.out_tokens for r in reqs])
            if kw:
                assert eng.stats()["spec"]["rounds"] > 0
    assert streams[1] == streams[0]
