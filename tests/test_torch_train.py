"""The port's train step against ``repro``'s, with the same weights and data.

``repro`` draws the weights (``jax.random``); ``repro_torch.bridge`` carries
them, and the optimizer state, across.  Inputs are made with numpy from a
seed and handed to both packages.  Everything runs in float32 on the CPU,
where the port's kernels are their plain versions.  Each test states its
tolerance; the two frameworks' CPU kernels sum in different orders, so bit
equality is not expected where floating-point sums are compared.
"""
from __future__ import annotations

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.core import SpData as JSpData  # noqa: E402
from repro.core import SpRuntime as JSpRuntime  # noqa: E402
from repro.core import sp_task as jax_sp_task  # noqa: E402
from repro.data import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.dist.collectives import compress_int8 as jax_compress_int8  # noqa: E402
from repro.dist.collectives import compress_tree as jax_compress_tree  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models.attention import _make_flash, blockwise_attention, reference_attention  # noqa: E402
from repro.models.config import ShapeSpec as JaxShape  # noqa: E402
from repro.models.layers import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.optim import clip_by_global_norm as jax_clip_by_global_norm  # noqa: E402
from repro.optim import schedule as jax_schedule  # noqa: E402
from repro.runtime.train import build_train_step as jax_build_train_step  # noqa: E402
from repro.runtime.train import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    params_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core import SpData, SpRuntime, sp_task  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.dist import collectives  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_fwd_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.config import ArchConfig, ShapeSpec  # noqa: E402
from repro_torch.optim import clip_by_global_norm, global_norm, leaf_path, schedule  # noqa: E402
from repro_torch.runtime.train import build_train_step, init_train_state  # noqa: E402


def _port_cfg(jcfg) -> ArchConfig:
    """A dense JAX config as the port's (pure data, no nested family configs)."""
    return ArchConfig(**dataclasses.asdict(jcfg))


def _tree_leaves(tree: dict) -> dict:
    """'/'-joined key path → numpy leaf."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf in flat}


# ---------------------------------------------------------------------------
# Plain backward versions against JAX's autodiff
# ---------------------------------------------------------------------------

# (Lq, Lk, H, KH, causal, window, q_offset[, head dim, 16 if absent]); Lk a
# multiple of the 16-key blocks
ATTN_CASES = [
    (64, 64, 4, 4, True, None, 0),
    (64, 64, 4, 2, True, 20, 0),  # GQA + window
    (48, 64, 4, 1, True, None, 16),  # MQA, queries offset into the keys
    (32, 32, 4, 2, False, None, 0),
    (64, 64, 2, 2, True, None, 0, 256),  # gemma-7b's head dim
    (48, 64, 2, 1, True, 20, 16, 256),
]


def _attn_case(case):
    """→ (Lq, Lk, H, KH, causal, window, q_offset, head dim)."""
    return (*case, 16) if len(case) == 7 else case


@pytest.mark.parametrize("route", ["custom_vjp", "reference"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_bwd_ref_matches_jax_vjp(case, route):
    """Output and (dq, dk, dv) of the plain versions against ``jax.vjp`` of
    ``repro``'s custom-VJP flash attention and of its reference attention,
    within 2e-6 of each output's largest magnitude (f32 sums in other
    orders; observed ≤ 6e-7)."""
    Lq, Lk, H, KH, causal, window, q_offset, D = _attn_case(case)
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((2, Lq, H, D), (2, Lk, KH, D), (2, Lk, KH, D), (2, Lq, H, D)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if route == "custom_vjp":
        fn = lambda q, k, v: blockwise_attention(q, k, v, block_kv=16, mode="masked", **kw)  # noqa: E731
    else:
        fn = lambda q, k, v: reference_attention(q, k, v, **kw)  # noqa: E731
    jout, vjp = jax.vjp(fn, q, k, v)
    want = (jout,) + vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = attention_fwd_ref(tq, tk, tv, **kw)
    got = (out,) + attention_bwd_ref(tq, tk, tv, out, lse, tdo, **kw)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-6 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_lse_matches_custom_vjp_residual(case):
    """The plain forward's lse is the natural-log ``m + log(l)`` that
    ``repro``'s custom VJP keeps as its residual (within 1e-5 absolute: the
    values are O(log Lk))."""
    Lq, Lk, H, KH, causal, window, q_offset, D = _attn_case(case)
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((2, Lq, H, D), (2, Lk, KH, D), (2, Lk, KH, D)))
    _, res = _make_flash(causal, window, 16, q_offset, "masked").fwd(q, k, v)
    _, lse = attention_fwd_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                               window=window, q_offset=q_offset)
    assert tuple(lse.shape) == (2, H, Lq)
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[4]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 7, 64), (33, 128), (5, 37), (3, 4096)])
def test_rmsnorm_bwd_ref_matches_jax_vjp(shape):
    """(dx, dscale) against ``jax.vjp`` of ``repro.models.layers.rmsnorm``,
    within 2e-6 of each output's largest magnitude (f32)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x, s: jax_rmsnorm(x, s, 1e-6), x, s)
    want = vjp(jnp.asarray(dy))
    got = rmsnorm_bwd_ref(*map(torch.from_numpy, (x, s, dy)), 1e-6)
    for name, g, w in zip(("dx", "dscale"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-6 * np.abs(w).max(), err_msg=name)


# ---------------------------------------------------------------------------
# The loss and every parameter's gradient
# ---------------------------------------------------------------------------

GRAD_CASES = {
    # L = 32 < attn_blockwise_min_seq (64): repro's reference attention
    "reference-L32": (dict(), 32),
    # L = 128: repro's custom-VJP blockwise attention (attn_mode "masked")
    "custom-vjp-L128": (dict(), 128),
    "logits-chunk": (dict(logits_chunk=16), 32),
    "gqa-qknorm-qkvbias": (dict(n_kv_heads=2, qk_norm=True, qkv_bias=True), 128),
    "remat-none": (dict(remat="none", logits_chunk=32), 64),
    # mamba2 (block kind ssm, chunks of 8): a padded 5-row tail, remat "full"
    "mamba2-L61": (dict(arch="mamba2-130m"), 61),
    "mamba2-remat-none-L64": (dict(arch="mamba2-130m", remat="none"), 64),
    # gemma-7b's layout (GeGLU, tied and scaled embeddings) at its head dim 256
    "gemma-head256-L64": (dict(arch="gemma-7b", head_dim=256, n_heads=2, n_kv_heads=2), 64),
}


def _configs(arch: str = "deepseek-7b", **over):
    """``repro``'s reduced config in float32 and the port's copy of it."""
    jcfg = jax_reduced_config(arch).replace(dtype="float32", **over)
    if arch == "deepseek-7b":
        return jcfg, _port_cfg(jcfg)
    return jcfg, reduced_config(arch).replace(dtype="float32", **over)


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_loss_and_grads_match_repro(name):
    """The loss within 1e-5 relative, and each parameter's gradient within
    1e-4 of its leaf's largest magnitude (f32; observed ≤ 1e-6), against
    ``jax.value_and_grad(repro.models.loss_fn)``."""
    over, L = GRAD_CASES[name]
    jcfg, cfg = _configs(**over)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    for leaf in ("bq", "bk", "bv") if jcfg.qkv_bias else ():  # zero-initialised: make them matter
        jparams["layers"]["attn"][leaf] = 0.1 * jax.random.normal(
            jax.random.PRNGKey(5), jparams["layers"]["attn"][leaf].shape)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, size=(2, L + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg),
        has_aux=True)(jparams)
    model = tm.set_trainable(params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    loss, _ = tm.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    names, tensors = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, tensors)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = _tree_leaves(jgrads)
    for n, g in zip(names, grads):
        path, layer = leaf_path(n)
        w = want[path] if layer is None else want[path][layer]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=n)


def test_remat_dots_saveable_names_its_roadmap_line():
    cfg = reduced_config("deepseek-7b").replace(dtype="float32", remat="dots_saveable")
    model = tm.set_trainable(tm.init_params(cfg, 0, device="cpu"))
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.loss_fn(model, {"tokens": toks, "labels": toks}, cfg)
    with torch.no_grad():  # serving never remats: the knob is not read there
        tm.prefill(model, {"tokens": toks}, cfg)


# ---------------------------------------------------------------------------
# The staged train step
# ---------------------------------------------------------------------------

def _pair_states(jcfg, cfg=None, seed=0):
    js = jax_init_train_state(jax.random.PRNGKey(seed), jcfg)
    st = train_state_from_numpy(jax.tree.map(np.asarray, js.params),
                                jax.tree.map(np.asarray, js.opt), js.step, cfg or _port_cfg(jcfg), "cpu")
    return js, st


# adamw's update m / (sqrt(v) + eps) does not scale with the gradient, so an
# element whose gradient sums to float noise can move by a fraction of the
# step's lr (3e-4) differently in the two packages: its parameters are held
# within 3e-5 (a tenth of one step), observed 3e-6.  adafactor's update is
# clipped by its RMS over the whole leaf and is held within 1e-6 (observed
# 2.4e-7).  Optimizer state within 1e-5 of its leaf's largest magnitude;
# with int8 compression within 1e-2 of it: a gradient element that lands
# within float noise of a half step of the int8 grid rounds to neighbouring
# integers in the two packages, which moves its m by (1 - b1)·scale =
# 0.1·max|g| / 127, about max|m| / 127 (observed once in 8192 elements).
# mamba2's AdamW state is held within 2e-5 of its leaf's largest magnitude:
# the same mechanism moves its parameters by up to 1.9e-5 (within 3e-5), and
# the SSD's exp(cumsum) chain carries that into the next steps' gradients
# more than the dense model does (observed 1.17e-5 in m of in_proj after 3
# steps; the first step's gradients agree within 1.2e-6 of each leaf's max).
PARAM_ATOL = {"adamw": 3e-5, "adafactor": 1e-6}
OPT_ATOL = {"mamba2-130m": {"adamw": 2e-5, "adafactor": 1e-5}}
STEP_CASES = [("adamw", 1, False), ("adamw", 2, False), ("adafactor", 1, False),
              ("adafactor", 2, False), ("adamw", 2, True),
              ("adamw", 2, False, "mamba2-130m"), ("adafactor", 2, False, "mamba2-130m")]


def _step_id(case) -> str:
    opt, n_mb, compress, *arch = case
    return "-".join([opt, str(n_mb), "int8" if compress else "f32", *arch])


@pytest.mark.parametrize("case", [pytest.param(c, id=_step_id(c)) for c in STEP_CASES])
def test_train_steps_match_repro(case):
    """Three steps of ``build_train_step`` from bridged state: loss and grad
    norm within 1e-4 relative at every step (observed ≤ 2e-7), then every
    parameter and optimizer-state leaf (tolerances above).  Reduced
    deepseek-7b, and reduced mamba2-130m (chunks of 8, 32 tokens)."""
    opt, n_mb, compress, *arch = case
    jcfg, cfg = _configs(*arch, optimizer=opt)
    js, st = _pair_states(jcfg, cfg)
    jart = jax_build_train_step(jcfg, n_microbatches=n_mb, grad_compression=compress, donate=False)
    art = build_train_step(cfg, n_microbatches=n_mb, grad_compression=compress)
    ds = JaxDataset(jcfg, JaxShape("t", "train", 32, 4), seed=0)
    for step in range(3):
        b = ds.batch_for_step(step)
        js, jm = jart(js, {k: jnp.asarray(v) for k, v in b.items()})
        st, m = art(st, {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("loss", "ce_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=f"{key} {step}")
    p_tree, o_tree, n = train_state_to_numpy(st)
    assert n == int(js.step) == 3
    want_p, got_p = _tree_leaves(jax.tree.map(np.asarray, js.params)), _tree_leaves(p_tree)
    assert sorted(want_p) == sorted(got_p)
    for k, w in want_p.items():
        np.testing.assert_allclose(got_p[k], w, rtol=0, atol=PARAM_ATOL[opt], err_msg=k)
    want_o, got_o = _tree_leaves(jax.tree.map(np.asarray, js.opt)), _tree_leaves(o_tree)
    assert sorted(want_o) == sorted(got_o)
    for k, w in want_o.items():
        atol = (1e-2 if compress else OPT_ATOL.get("".join(arch), {}).get(opt, 1e-5)) * np.abs(w).max()
        np.testing.assert_allclose(got_o[k], w, rtol=0, atol=atol, err_msg=k)


def test_global_norm_is_accurate_at_embedding_size():
    """2e7 float32 elements (a fifth of deepseek-7b's embedding gradient):
    within 1e-6 of the float64 norm, where a plain float32 vector norm on
    the CPU is off by ~1e-3 and broke the card-vs-CPU train parity."""
    t = torch.randn(20_000_000, generator=torch.Generator().manual_seed(0)) * 1e-3
    small = torch.ones(5)
    want = float(torch.sqrt(t.double().square().sum() + 5.0))
    np.testing.assert_allclose(float(global_norm([t, small])), want, rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_repro(max_norm):
    """Clipped leaves and the norm within 1e-6 relative (float32), clipping
    (0.5) and not (100)."""
    rng = np.random.default_rng(6)
    tree = {"a": rng.standard_normal((7, 5)).astype(np.float32), "b": rng.standard_normal(9).astype(np.float32)}
    want, want_norm = jax_clip_by_global_norm(tree, max_norm)
    got, norm = clip_by_global_norm({k: torch.from_numpy(v) for k, v in tree.items()}, max_norm)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


def test_schedule_names_match_repro():
    jcfg = jax_reduced_config("deepseek-7b").replace(dtype="float32")
    js, st = _pair_states(jcfg)
    ds = JaxDataset(jcfg, JaxShape("t", "train", 16, 8), seed=0)
    b = ds.batch_for_step(0)
    jart = jax_build_train_step(jcfg, n_microbatches=4, schedule_policy="overlap", jit=False)
    jart(js, {k: jnp.asarray(v) for k, v in b.items()})
    art = build_train_step(_port_cfg(jcfg), n_microbatches=4, schedule_policy="overlap")
    art(st, {k: torch.from_numpy(v) for k, v in b.items()})
    assert art.schedule_names == jart.schedule_names
    assert art.schedule_names == ["mb0", "mb1", "mb2", "mb3", "grad_allreduce", "optimizer"]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().view({4: torch.int32, 2: torch.int16}[t.element_size()]).clone()


def test_nonfinite_rollback_keeps_every_bit():
    """As ``tests/test_train_runtime.py::test_nonfinite_rollback``: a NaN in
    one ``ln1`` scale makes the grad norm NaN; the step still advances and
    every parameter (the NaN cell included) and optimizer tensor keeps its
    bits."""
    cfg = reduced_config("deepseek-7b")  # bfloat16 parameters
    st = init_train_state(cfg, 2, device="cpu")
    with torch.no_grad():
        st.params.layers[0].ln1.scale[0] = float("nan")
    before = {n: _bits(p) for n, p in st.params.named_parameters()}
    opt_before = {n: _bits(t) for n, t in st.opt["m"].items()}
    art = build_train_step(cfg, n_microbatches=1)
    b = SyntheticLMDataset(cfg, ShapeSpec("t", "train", 32, 4), seed=0).batch_for_step(0)
    st, m = art(st, {k: torch.from_numpy(v) for k, v in b.items()})
    assert not bool(torch.isfinite(m["grad_norm"]))
    assert int(st.step) == 1
    for n, p in st.params.named_parameters():
        assert torch.equal(_bits(p), before[n]), n
    for n, t in st.opt["m"].items():
        assert torch.equal(_bits(t), opt_before[n]), n


def test_staged_runtime_policies_match_repro():
    """The same graph on both packages' staged runtimes runs in the same
    order under every policy; ``elastic=True`` names its ROADMAP item."""
    def build(rt_cls, data_cls, task, policy):
        a = task(read=("x",), write=("y",), name="a")(lambda x, y: None)
        c = task(write=("y",), name="comm", comm=True, cost=3.0)(lambda y: None)
        p = task(read=("x",), write=("z",), name="p", priority=5)(lambda x, z: None)
        x, y, z, w = (data_cls(0) for _ in range(4))
        with rt_cls(backend="staged", policy=policy) as rt:
            a(x, y)
            p(x, w)
            c(y)
            p(y, z)
            order = rt.run()
        return [t.name for t in order]

    for policy in ("fifo", "priority", "critical_path", "overlap"):
        assert build(SpRuntime, SpData, sp_task, policy) == build(JSpRuntime, JSpData, jax_sp_task, policy)
    # the elastic runtime is ported: it builds and runs a local elastic loop
    with SpRuntime(elastic=True, workers=1) as rt:
        assert rt.elastic_loop(lambda step: step * step, 4) == {0: 0, 1: 1, 2: 4, 3: 9}
    assert rt.recoveries == [] and rt.epoch == 0


# ---------------------------------------------------------------------------
# Compression, data, schedules
# ---------------------------------------------------------------------------

def test_compress_tree_matches_repro():
    """int8 values and scales exactly (one rounding rule: half to even), the
    dequantized leaves and residuals within 1e-6 of their largest magnitude."""
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": (1e-3 * rng.standard_normal(11)).astype(np.float32),
                  "d": np.zeros((3,), np.float32)}}
    res = {"a": (0.01 * rng.standard_normal((5, 7))).astype(np.float32),
           "b": {"c": np.zeros(11, np.float32), "d": np.ones(3, np.float32)}}
    for leaf in (tree["a"], tree["b"]["c"], tree["b"]["d"]):
        jq, js = jax_compress_int8(leaf)
        q, s = collectives.compress_int8(torch.from_numpy(leaf))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
    jdeq, jres = jax_compress_tree(tree, res)
    to_t = lambda t: {k: to_t(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in t.items()}  # noqa: E731
    deq, new_res = collectives.compress_tree(to_t(tree), to_t(res))
    for got, want in ((deq, jdeq), (new_res, jres)):
        w = _tree_leaves(want)
        for k, g in _tree_leaves(jax.tree.map(lambda t: t.numpy(), got)).items():
            np.testing.assert_allclose(g, w[k], rtol=0, atol=1e-6 * max(np.abs(w[k]).max(), 1e-30))
    zeros = collectives.init_residuals(to_t(tree))
    assert float(zeros["b"]["c"].abs().sum()) == 0.0 and zeros["a"].dtype == torch.float32


@pytest.mark.parametrize("seq,batch,seed", [(32, 8, 0), (17, 3, 5)])
def test_batch_for_step_matches_repro(seq, batch, seed):
    jcfg = jax_reduced_config("deepseek-7b")
    jds = JaxDataset(jcfg, JaxShape("t", "train", seq, batch), seed=seed)
    ds = SyntheticLMDataset(_port_cfg(jcfg), ShapeSpec("t", "train", seq, batch), seed=seed)
    for step in (0, 1, 9):
        want, got = jds.batch_for_step(step), ds.batch_for_step(step)
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("kind", ["constant", "cosine", "warmup_cosine"])
def test_schedules_match_repro(kind):
    """At steps 0, 5 and 50, within 1e-6 relative (float32)."""
    make = {
        "constant": lambda m: m.constant_schedule(1e-3),
        "cosine": lambda m: m.cosine_schedule(1e-3, 40),
        "warmup_cosine": lambda m: m.linear_warmup_cosine(1e-3, warmup=10, total_steps=60),
    }[kind]
    jfn, fn = make(jax_schedule), make(schedule)
    for step in (0, 5, 50):
        want = float(jfn(jnp.int32(step)))
        got = fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launcher_loss_decreases_on_cpu():
    """As ``tests/test_train_runtime.py::test_loss_decreases``: 30 steps of
    the reduced deepseek-7b lower the loss by more than 0.5."""
    out = launch_train.main(["--arch", "deepseek-7b", "--reduced", "--device", "cpu",
                             "--steps", "30", "--batch", "8", "--seq", "32",
                             "--microbatches", "2", "--log-every", "0"])
    assert out["final_step"] == 30 and len(out["losses"]) == 30
    assert out["losses"][-1] < out["losses"][0] - 0.5


def test_launcher_raises_without_a_card_or_for_unported_flags(tmp_path, capsys):
    """The fault flags are ported: ``--fail-at 2:1`` on one device prints the
    one-device line and the run ends with the losses of a run without it;
    ``--bench-out`` writes the recovery JSON.  Without a card the default
    device raises."""
    argv = ["--reduced", "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "16",
            "--log-every", "0"]
    out = tmp_path / "recovery.json"
    got = launch_train.main(argv + ["--fail-at", "2:1", "--recovery", "live",
                                    "--bench-out", str(out)])
    assert "failure injected but only one device; continuing" in capsys.readouterr().out
    want = launch_train.main(argv)
    assert got["losses"] == want["losses"] and len(got["losses"]) == 3
    assert json.loads(out.read_text()) == {"recoveries": [], "final_step": 3}
    with pytest.raises(SystemExit):
        launch_train.main(argv + ["--fail-at", "0:1"])  # STEP must be >= 1
    if dispatch.cuda_available():
        pytest.skip("a Hopper card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch_train.main(["--reduced", "--steps", "1"])


@pytest.mark.parametrize("arch", ["minicpm3-4b", "recurrentgemma-9b", "qwen3-moe-235b-a22b"])
def test_launcher_other_families_on_cpu(arch):
    """MLA, the RG-LRU hybrid and MoE through the train launcher on the CPU:
    a few steps return finite losses and the final step."""
    out = launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--steps", "3", "--batch", "4", "--seq", "32",
                             "--microbatches", "2", "--log-every", "0"])
    assert out["final_step"] == 3 and len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"]))


def test_launcher_mamba2_loss_decreases_on_cpu():
    """Reduced mamba2-130m (block kind ssm, chunks of 8) through the
    launcher on the CPU: 30 steps lower the loss by more than 0.5."""
    out = launch_train.main(["--arch", "mamba2-130m", "--reduced", "--device", "cpu",
                             "--steps", "30", "--batch", "8", "--seq", "32",
                             "--microbatches", "2", "--log-every", "0"])
    assert out["final_step"] == 30 and len(out["losses"]) == 30
    assert all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0] - 0.5


@pytest.mark.parametrize("recovery", ["live", "restore"])
def test_launcher_recovers_from_a_rank_death_inside_the_runtime(tmp_path, monkeypatch, recovery):
    """A step that raises ``SpRankDeadError`` (injected into the train-step
    artifact's second call, before it touches the state) is recovered by
    the elastic runtime through the launcher's ``on_reshard``: ``live``
    keeps the in-memory state, ``restore`` reloads the checkpoint of step
    1; either way the run ends with an unbroken run's losses and the
    recovery is in the ``--bench-out`` JSON."""
    from repro_torch.core import SpRankDeadError

    build = launch_train.build_train_step

    def flaky_build(*args, **kw):
        art, calls = build(*args, **kw), []

        def step(state, batch):
            calls.append(1)
            if len(calls) == 2:
                raise SpRankDeadError("injected loss of a rank")
            return art(state, batch)

        return step

    argv = ["--reduced", "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "16",
            "--log-every", "0"]
    want = launch_train.main(argv)
    monkeypatch.setattr(launch_train, "build_train_step", flaky_build)
    out = tmp_path / "recovery.json"
    got = launch_train.main(argv + ["--recovery", recovery, "--bench-out", str(out),
                                    "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "1"])
    assert got == want
    (rec,) = json.loads(out.read_text())["recoveries"]
    assert (rec["mode"], rec["step"]) == (recovery, 1) and rec["seconds"] >= 0.0
