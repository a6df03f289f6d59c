"""The port's mixture-of-experts (qwen3-moe-235b-a22b, llama4-scout) against
``repro``'s.

``repro`` draws the weights (``jax.random``); ``repro_torch.bridge`` carries
them across.  Inputs are drawn with numpy from a seed.  Everything runs in
float32 on the CPU, where the port's kernels are their plain versions.  The
reduced configs have 4 experts (qwen3: top 2; llama4: top 1 and a shared
expert).  Both dispatches, ``einsum`` (the configs' default) and
``scatter``, run with the config's capacity factor and with a small one
(0.25) that drops tokens past an expert's capacity.

Tolerances: the layer's output and the model's hidden states, logits and
caches within rtol / atol 1e-4 (``test_torch_model.py``'s), the aux losses
within 1e-5 relative; the loss within 1e-5 relative; each gradient within
1e-4 of its leaf's largest magnitude; train-step parameters within 1e-6
(Adafactor, ``test_torch_train.py``'s).  Greedy token streams are equal.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.data import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models.config import ShapeSpec as JaxShape  # noqa: E402
from repro.runtime.serve import prime_cache as jax_prime_cache  # noqa: E402
from repro.runtime.train import build_train_step as jax_build_train_step  # noqa: E402
from repro.runtime.train import init_train_state as jax_init_train_state  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.bridge import params_from_numpy, train_state_from_numpy, train_state_to_numpy  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.optim import leaf_path  # noqa: E402
from repro_torch.runtime.serve import prime_cache  # noqa: E402
from repro_torch.runtime.train import build_train_step  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402

pytestmark = pytest.mark.timeout(300)

ARCHS = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e")
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol=TOL, msg="") -> None:
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


def _tree_leaves(tree: dict) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf in flat}


def _cfgs(arch, **moe):
    jcfg = jax_reduced_config(arch).replace(dtype="float32")
    cfg = reduced_config(arch).replace(dtype="float32")
    if moe:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    return jcfg, cfg


_PARAMS: dict = {}


def _pair(arch, **moe):
    jcfg, cfg = _cfgs(arch, **moe)
    if arch not in _PARAMS:
        jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
        _PARAMS[arch] = (jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    return (jcfg, cfg) + _PARAMS[arch]


def test_config_copies_match_repro():
    for arch in ARCHS:
        assert repr(jax_reduced_config(arch)) == repr(reduced_config(arch)), arch
        assert tm.block_kind(reduced_config(arch)) == "moe"


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25], ids=["capacity", "overflow"])
@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_repro(arch, dispatch, capacity_factor):
    """One layer's output and aux losses for 2 × 40 tokens."""
    jcfg, cfg, jparams, model = _pair(arch, dispatch=dispatch, capacity_factor=capacity_factor)
    jp = jax.tree.map(lambda t: t[0], jparams["layers"]["moe"])
    x = np.random.default_rng(1).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    jy, jaux = jax_moe.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_apply(model.layers[0].moe, torch.from_numpy(x), cfg)
    _close(ty, jy, msg="y")
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    if capacity_factor < 1:  # fewer slots than (token, choice) pairs: some are dropped
        assert tmoe.capacity(80, cfg) * cfg.moe.n_experts < 80 * cfg.moe.top_k


def test_dispatches_agree_when_nothing_overflows():
    """With room for every token the two dispatches compute the same sums."""
    jcfg, cfg, _, model = _pair(ARCHS[0], capacity_factor=4.0)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 24, cfg.d_model)).astype(np.float32))
    ye, ae = tmoe.moe_apply(model.layers[1].moe, x, cfg)
    scfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch="scatter"))
    ys, as_ = tmoe.moe_apply(model.layers[1].moe, x, scfg)
    _close(ye, ys, dict(rtol=1e-5, atol=1e-5))
    assert all(float(ae[k]) == float(as_[k]) for k in ae)


def test_einsum_dispatch_is_batch_invariant():
    """A decode step's token gives the same bits beside any other tokens
    while none is dropped (4 tokens, capacity 8), with qwen3-moe's 128
    experts top-8: its capacity slots move with the others' choices, and
    the combine does not add in slot order (a (G, S, E, C) einsum does, and
    fails this check)."""
    cfg = reduced_config(ARCHS[0]).replace(dtype="float32", d_model=512, n_layers=1, moe=dataclasses.replace(
        reduced_config(ARCHS[0]).moe, n_experts=128, top_k=8, d_ff_expert=64))
    layer = tm.init_params(cfg, 0, device="cpu").layers[0].moe
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((4, 1, cfg.d_model)).astype(np.float32))
    want = tmoe.moe_apply(layer, x, cfg)[0]
    for trial in range(3):
        other = torch.from_numpy(rng.standard_normal((4, 1, cfg.d_model)).astype(np.float32))
        for b in range(4):
            mixed = other.clone()
            mixed[b] = x[b]
            got = tmoe.moe_apply(layer, mixed, cfg)[0]
            assert torch.equal(got[b], want[b]), (trial, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_repro(arch):
    """Hidden states and summed aux, prefill logits and primed caches, then
    four decode steps at two positions (einsum dispatch at decode: C = 8
    covers both tokens)."""
    jcfg, cfg, jparams, model = _pair(arch)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, size=(2, 13)).astype(np.int32)
    jx, _, jaux = jax_forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    tx, _, taux = tm.forward(model, {"tokens": torch.from_numpy(toks)}, cfg)
    _close(tx, jx, msg="hidden")
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    jl, jc = jax_prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = tm.prefill(model, {"tokens": torch.from_numpy(toks)}, cfg)
    _close(tl, jl, msg="logits")
    jcache, tcache = jax_prime_cache(jcfg, jc, 13, 24), prime_cache(cfg, tc, 13, 24)
    tok = np.array(jnp.argmax(jl[:, 0], axis=-1), np.int32)[:, None]
    for step in range(4):
        pos = np.asarray([13 + step, 13 + step], np.int32)
        jl, jcache = jax_decode_step(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos), jcfg)
        tl, tcache = tm.decode_step(model, torch.from_numpy(tok), tcache, torch.from_numpy(pos), cfg)
        _close(tl, jl, msg=f"step {step}")
        tok = np.array(jnp.argmax(jl[:, 0], axis=-1), np.int32)[:, None]
    for k in ("k", "v"):
        _close(tcache[k], jcache[k], msg=k)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_grads_match_repro(arch, dispatch):
    """The loss (cross-entropy + weighted aux terms over the layers) within
    1e-5 relative, the aux metrics within 1e-5 relative, and every gradient
    (the router's through the aux losses and the combine weights) within
    1e-4 of its leaf's largest magnitude."""
    jcfg, cfg, jparams, _ = _pair(arch, dispatch=dispatch)
    model = tm.set_trainable(params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    toks = np.random.default_rng(4).integers(0, cfg.vocab, size=(2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg), has_aux=True)(jparams)
    loss, m = tm.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    assert set(m) == set(jm) == {"ce_loss", "moe_balance", "moe_zloss"}
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    names, tensors = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, tensors)
    want = _tree_leaves(jgrads)
    for n, g in zip(names, grads):
        path, layer = leaf_path(n)
        w = want[path] if layer is None else want[path][layer]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-12, err_msg=n)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_adafactor_steps_match_repro(arch):
    """Two staged train steps: the expert weights (E, D, F) a layer are
    factored per expert as ``repro`` factors its (L, E, D, F) leaf; the
    step reports the aux metrics as ``loss_fn`` does."""
    jcfg = jax_reduced_config(arch).replace(dtype="float32", optimizer="adafactor")
    cfg = reduced_config(arch).replace(dtype="float32", optimizer="adafactor")
    js = jax_init_train_state(jax.random.PRNGKey(0), jcfg)
    st = train_state_from_numpy(jax.tree.map(np.asarray, js.params), jax.tree.map(np.asarray, js.opt),
                                js.step, cfg, "cpu")
    assert tuple(st.opt["layers/moe/wi_gate"]["vr"].shape) == (2, 4, cfg.d_model)
    jart = jax_build_train_step(jcfg, n_microbatches=2, donate=False)
    art = build_train_step(cfg, n_microbatches=2)
    ds = JaxDataset(jcfg, JaxShape("t", "train", 32, 4), seed=0)
    for step in range(2):
        b = ds.batch_for_step(step)
        js, jm = jart(js, {k: jnp.asarray(v) for k, v in b.items()})
        st, m = art(st, {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("loss", "ce_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=f"{key} {step}")
        assert {"moe_balance", "moe_zloss"} <= set(m) and all(torch.isfinite(m[k]) for k in m)
    p_tree, o_tree, n = train_state_to_numpy(st)
    assert n == 2
    want_p, got_p = _tree_leaves(jax.tree.map(np.asarray, js.params)), _tree_leaves(p_tree)
    assert sorted(want_p) == sorted(got_p)
    for k, w in want_p.items():
        np.testing.assert_allclose(got_p[k], w, rtol=0, atol=1e-6, err_msg=k)
    want_o, got_o = _tree_leaves(jax.tree.map(np.asarray, js.opt)), _tree_leaves(o_tree)
    for k, w in want_o.items():
        np.testing.assert_allclose(got_o[k], w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_engine_streams_match_repro():
    """qwen3-moe (einsum dispatch): staggered greedy prompts, then a
    duplicate that shares the first prompt's full blocks, in both engines."""
    jcfg, cfg, jparams, model = _pair(ARCHS[0])
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (5, 9, 13)]
    out = []
    for eng in (JaxServeEngine(jcfg, jparams, n_slots=3, max_seq=32, block_size=4),
                ServeEngine(cfg, model, n_slots=3, max_seq=32, block_size=4, device="cpu")):
        with eng:
            reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
            eng.run_until_drained(max_iters=60)
            dup = eng.submit(prompts[2], 6)
            eng.run_until_drained(max_iters=60)
            assert all(r.done for r in reqs + [dup])
            out.append(([r.out_tokens for r in reqs + [dup]], eng.prefills, eng.restores))
    assert out[1] == out[0]
