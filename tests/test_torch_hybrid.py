"""The port's RG-LRU block and recurrentgemma hybrid against ``repro``'s.

``repro`` draws the weights (``jax.random``); ``repro_torch.bridge`` carries
them across (its super-block leaves ``layers/rec_0`` / ``rec_1`` /
``attn_2`` and the unstacked ``tail_0`` / ``tail_1`` by the model's
``leaf_layout``).  Inputs are drawn with numpy from a seed.  Everything
runs in float32 on the CPU, where the port's kernels are their plain
versions.  The reduced config has 5 layers (one (rec, rec, attn)
super-block and two rec tail layers) and a local window of 16, so decode
runs past the window and the attention ring wraps.

``repro`` nests its decode caches ({"scan": {"rec_0": {h, conv}, ...},
"tail": [...]}); the port keeps one flat dict stacked over the layers of
each kind, in layer order, which :func:`_flat` builds from ``repro``'s.

Tolerances: the doubling scan against a sequential loop 1e-5 (relative
and absolute; float32, at most ⌈log₂ L⌉ extra roundings) and against
``jax.lax.associative_scan`` the same; hidden states, logits and caches
within rtol / atol 1e-4 (``test_torch_model.py``'s); the loss within 1e-5
relative; each gradient within 1e-4 of its leaf's largest magnitude;
train-step parameters within 1e-6 (Adafactor, ``test_torch_train.py``'s).
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
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402
from repro.models.config import ShapeSpec as JaxShape  # noqa: E402
from repro.runtime.serve import prime_cache as jax_prime_cache  # noqa: E402
from repro.runtime.train import build_train_step as jax_build_train_step  # noqa: E402
from repro.runtime.train import init_train_state as jax_init_train_state  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.bridge import params_from_numpy, train_state_from_numpy, train_state_to_numpy  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.optim import leaf_path, param_leaves  # noqa: E402
from repro_torch.runtime.serve import prime_cache  # noqa: E402
from repro_torch.runtime.train import build_train_step  # noqa: E402
from repro_torch.serving import ServeEngine, shrunken_draft  # noqa: E402

pytestmark = pytest.mark.timeout(300)

ARCH = "recurrentgemma-9b"
TOL = dict(rtol=1e-4, atol=1e-4)
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol=TOL, msg="") -> None:
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


def _tree_leaves(tree: dict) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf in flat}


def _flat(jcfg, caches) -> dict:
    """``repro``'s nested hybrid caches → the port's flat dict: each leaf
    stacked over the layers of its kind in layer order."""
    pat = jcfg.hybrid.pattern
    per_layer = []
    n_super = caches["scan"][f"{pat[0]}_0"][next(iter(caches["scan"][f"{pat[0]}_0"]))].shape[0]
    for s in range(n_super):
        per_layer += [jax.tree.map(lambda t: t[s], caches["scan"][f"{k}_{i}"]) for i, k in enumerate(pat)]
    per_layer += list(caches["tail"])
    keys = dict.fromkeys(k for c in per_layer for k in c)
    return {k: np.stack([np.asarray(c[k]) for c in per_layer if k in c]) for k in keys}


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_reduced_config(ARCH).replace(dtype="float32")
    cfg = reduced_config(ARCH).replace(dtype="float32")
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    # zero-initialised biases: make them matter
    for where in (jparams["layers"]["rec_0"], jparams["tail_1"]):
        for name in ("b_a", "b_x", "conv_b"):
            leaf = where["rec"][name]
            where["rec"][name] = 0.5 * jax.random.normal(jax.random.PRNGKey(3), leaf.shape)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, model


def test_config_copy_and_layout():
    jcfg, cfg = jax_reduced_config(ARCH), reduced_config(ARCH)
    assert repr(jcfg) == repr(cfg)
    assert tm.layer_kinds(cfg) == ["rec", "rec", "attn", "rec", "rec"]
    assert tm.leaf_layout(cfg) == (("layers/rec_0", 0), ("layers/rec_1", 0), ("layers/attn_2", 0),
                                   ("tail_0", None), ("tail_1", None))
    full = tm.leaf_layout(get_config(ARCH))
    assert len(full) == 38 and full[35] == ("layers/attn_2", 11) and full[37] == ("tail_1", None)
    assert leaf_path("layers.4.rec.w_a", tm.leaf_layout(cfg)) == ("tail_1/rec/w_a", None)
    assert leaf_path("layers.2.ln1.scale", tm.leaf_layout(cfg)) == ("layers/attn_2/ln1", 0)


@pytest.mark.parametrize("L", [1, 2, 7, 16, 33])
def test_doubling_scan_matches_a_sequential_loop_and_repro(L):
    rng = np.random.default_rng(L)
    a = rng.uniform(0.5, 1.0, (2, L, 6)).astype(np.float32)
    b = rng.standard_normal((2, L, 6)).astype(np.float32)
    h0 = rng.standard_normal((2, 6)).astype(np.float32)
    for init in (None, h0):
        got = trglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                                None if init is None else torch.from_numpy(init))
        h = np.zeros((2, 6), np.float32) if init is None else init.copy()
        want = []
        for t in range(L):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        _close(got, np.stack(want, axis=1), SCAN_TOL, "sequential")
        jh = jax_rglru.rglru_scan(jnp.asarray(a), jnp.asarray(b), None if init is None else jnp.asarray(init))
        _close(got, jh, SCAN_TOL, "associative_scan")


def test_rglru_block_apply_and_decode_match_repro(pair):
    jcfg, jparams, cfg, model = pair
    jp = jax.tree.map(lambda t: t[0], jparams["layers"]["rec_0"]["rec"])
    p = model.layers[0].rec
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    jy, jc = jax_rglru.rglru_apply(jp, jnp.asarray(x), jcfg, want_cache=True)
    ty, tc = trglru.rglru_apply(p, torch.from_numpy(x), cfg, want_cache=True)
    _close(ty, jy, msg="apply")
    for k in ("h", "conv"):
        _close(tc[k], jc[k], msg=k)
    tc = {k: v.clone() for k, v in tc.items()}
    for step in range(3):
        xs = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jax_rglru.rglru_decode_step(jp, jnp.asarray(xs), jc, jcfg)
        ty, tc = trglru.rglru_decode_step(p, torch.from_numpy(xs), tc, cfg)
        _close(ty, jy, msg=f"decode {step}")
    for k in ("h", "conv"):
        _close(tc[k], jc[k], msg=k)


@pytest.mark.parametrize("L", [13, 21])
def test_forward_prefill_and_primed_caches_match_repro(pair, L):
    """A prompt shorter and one longer than the window of 16 (the ring
    holds the last 16 positions)."""
    jcfg, jparams, cfg, model = pair
    toks = np.random.default_rng(L).integers(0, cfg.vocab, size=(2, L)).astype(np.int32)
    jx, _, _ = jax_forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    tx, _, _ = tm.forward(model, {"tokens": torch.from_numpy(toks)}, cfg)
    _close(tx, jx, msg="hidden")
    jl, jc = jax_prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = tm.prefill(model, {"tokens": torch.from_numpy(toks)}, cfg)
    _close(tl, jl, msg="logits")
    max_seq = 40
    jp = _flat(jcfg, jax_prime_cache(jcfg, jc, L, max_seq))
    tp = prime_cache(cfg, tc, L, max_seq)
    defs = tm.cache_defs(cfg, 2, max_seq)
    assert set(tp) == set(jp) == set(defs) == {"h", "conv", "k", "v"}
    for k in tp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape) == tuple(defs[k].shape), k
        _close(tp[k], jp[k], msg=k)
    assert tuple(tp["k"].shape) == (1, 2, 16, 1, cfg.head_dim)  # a ring of the window
    assert tm.cache_layout(cfg) is None


def test_decode_past_the_window_matches_repro(pair):
    """Two sequences (prompts 7 and 12) decode 12 steps together: positions
    pass 16 and the ring slots wrap; logits at every step, then every
    cache leaf."""
    jcfg, jparams, cfg, model = pair
    rng = np.random.default_rng(3)
    lens, max_seq = (7, 12), 40
    jcs, tcs, first = [], [], []
    for L in lens:
        toks = rng.integers(0, cfg.vocab, size=(1, L)).astype(np.int32)
        jl, jc = jax_prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
        _, tc = tm.prefill(model, {"tokens": torch.from_numpy(toks)}, cfg)
        jcs.append(jax_prime_cache(jcfg, jc, L, max_seq))
        tcs.append(prime_cache(cfg, tc, L, max_seq))
        first.append(int(jnp.argmax(jl[0, -1])))
    # the batch is axis 1 of the scanned leaves, axis 0 of the tail's
    jcache = {"scan": jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=1), *[c["scan"] for c in jcs]),
              "tail": [jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *[c["tail"][i] for c in jcs])
                       for i in range(2)]}
    tcache = {k: torch.cat([c[k] for c in tcs], dim=1) for k in tcs[0]}
    tok = np.asarray(first, np.int32)[:, None]
    for step in range(12):
        pos = np.asarray([L + step for L in lens], np.int32)
        jl, jcache = jax_decode_step(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos), jcfg)
        tl, tcache = tm.decode_step(model, torch.from_numpy(tok), tcache, torch.from_numpy(pos), cfg)
        _close(tl, jl, msg=f"step {step}")
        tok = np.array(jnp.argmax(jl[:, 0], axis=-1), np.int32)[:, None]
    want = _flat(jcfg, jcache)
    for k in tcache:
        _close(tcache[k], want[k], msg=k)


def test_loss_and_grads_match_repro(pair):
    jcfg, jparams, cfg, _ = pair
    model = tm.set_trainable(params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    toks = np.random.default_rng(4).integers(0, cfg.vocab, size=(2, 41)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg), has_aux=True)(jparams)
    loss, _ = tm.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    names, tensors = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, tensors)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = _tree_leaves(jgrads)
    seen = set()
    for n, g in zip(names, grads):
        path, layer = leaf_path(n, model.leaf_layout)
        seen.add(path)
        w = want[path] if layer is None else want[path][layer]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-12, err_msg=n)
    assert seen == set(want)


def test_two_adafactor_steps_match_repro():
    """Two staged train steps: Adafactor factors and clips by RMS over
    ``repro``'s stacked super-block leaves, which ``param_leaves`` rebuilds
    from the port's per-layer tensors by the layout."""
    jcfg = jax_reduced_config(ARCH).replace(dtype="float32", optimizer="adafactor")
    cfg = reduced_config(ARCH).replace(dtype="float32", optimizer="adafactor")
    js = jax_init_train_state(jax.random.PRNGKey(0), jcfg)
    st = train_state_from_numpy(jax.tree.map(np.asarray, js.params), jax.tree.map(np.asarray, js.opt),
                                js.step, cfg, "cpu")
    leaves = {lf.path: lf for lf in param_leaves(dict(st.params.named_parameters()), st.params.leaf_layout)}
    assert leaves["layers/rec_0/rec/w_a"].stacked and not leaves["tail_0/rec/w_a"].stacked
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


def test_engine_streams_and_re_prefill_match_repro(pair):
    """Staggered greedy prompts (one longer than the window) and a duplicate:
    the hybrid is not pageable, so the duplicate is prefilled again; the
    same streams and counts as ``repro``'s engine."""
    jcfg, jparams, cfg, model = pair
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (5, 19, 9)]
    out = []
    for eng in (JaxServeEngine(jcfg, jparams, n_slots=2, max_seq=40, block_size=4),
                ServeEngine(cfg, model, n_slots=2, max_seq=40, block_size=4, device="cpu")):
        with eng:
            reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
            eng.run_until_drained(max_iters=80)
            dup = eng.submit(prompts[1], 8)
            eng.run_until_drained(max_iters=80)
            assert all(r.done for r in reqs + [dup]) and dup.out_tokens == reqs[1].out_tokens
            out.append(([r.out_tokens for r in reqs + [dup]], eng.prefills, eng.restores))
    assert out[1] == out[0]
    assert out[1][1:] == (4, 0)


def test_speculation_refuses_the_hybrid(pair):
    _, _, cfg, model = pair
    with pytest.raises(ValueError, match="cache_layout"):
        shrunken_draft(cfg, model)
    dense_cfg, dense = shrunken_draft(reduced_config("deepseek-7b").replace(dtype="float32", vocab=cfg.vocab))
    with pytest.raises(ValueError, match="pageable"):
        ServeEngine(cfg, model, device="cpu", draft_cfg=dense_cfg,
                    draft_params=tm.init_params(dense_cfg, 0, device="cpu"))
