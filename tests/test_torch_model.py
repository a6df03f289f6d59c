"""The port's dense transformer against ``repro``'s, with the same weights.

``repro.models.init_params`` draws the weights; ``repro_torch.bridge`` carries
them across.  In float32 on the CPU, ``prefill`` logits, the primed caches
and a multi-step ``decode_step`` with per-slot positions must agree at
rtol/atol 1e-4: the two frameworks' CPU matmuls sum in different orders, so
bit equality is not expected, and 1e-4 is far below any modelling error.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.runtime.serve import prime_cache as jax_prime_cache  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.runtime.serve import prime_cache  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _serve_lm_cfg():
    """``examples/serve_lm.py``'s CFG (loaded from the example itself)."""
    path = Path(__file__).resolve().parents[1] / "examples" / "serve_lm.py"
    spec = importlib.util.spec_from_file_location("serve_lm_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CFG


def _configs():
    """(jax cfg, port cfg) pairs, float32."""
    out = {}
    for name in ("deepseek-7b", "gemma-7b", "qwen1.5-110b"):
        out[name] = (
            jax_reduced_config(name).replace(dtype="float32"),
            reduced_config(name).replace(dtype="float32"),
        )
    # qk_norm, logit softcap and a padded vocab (100 → 128 rows): the
    # layers no assigned dense config exercises at once
    variant = dict(dtype="float32", qk_norm=True, logit_softcap=30.0, vocab=100)
    out["deepseek-7b+qknorm+softcap+padvocab"] = (
        jax_reduced_config("deepseek-7b").replace(**variant),
        reduced_config("deepseek-7b").replace(**variant),
    )
    # gemma-7b at its full head dim (256), two heads
    head256 = dict(dtype="float32", head_dim=256, n_heads=2, n_kv_heads=2)
    out["gemma-7b+head256"] = (
        jax_reduced_config("gemma-7b").replace(**head256),
        reduced_config("gemma-7b").replace(**head256),
    )
    return out


CONFIGS = _configs()


def _port_cfg(jcfg) -> ArchConfig:
    """A dense JAX config as the port's (pure data, no nested family configs)."""
    return ArchConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module", params=sorted(CONFIGS) + ["serve_lm"])
def pair(request):
    if request.param == "serve_lm":
        jcfg = _serve_lm_cfg().replace(dtype="float32")
        cfg = _port_cfg(jcfg)
    else:
        jcfg, cfg = CONFIGS[request.param]
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    model = params_from_numpy(tree, cfg, device="cpu")
    return jcfg, jparams, cfg, model


def _t(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def test_port_config_copy_matches_repro():
    for name, (jcfg, cfg) in CONFIGS.items():
        assert repr(jcfg) == repr(cfg), name


def test_prefill_logits_and_caches_match(pair):
    jcfg, jparams, cfg, model = pair
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, size=(2, 13)).astype(np.int32)
    jl, jc = jax_prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = tm.prefill(model, {"tokens": torch.from_numpy(toks)}, cfg)
    assert tuple(tl.shape) == tuple(jl.shape)
    np.testing.assert_allclose(_t(tl), _t(jl), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(_t(tc[k]), _t(jc[k]), **TOL)
    # primed (decode-ready) caches
    jp = jax_prime_cache(jcfg, jc, toks.shape[1], 32)
    tp = prime_cache(cfg, tc, toks.shape[1], 32)
    for k in ("k", "v"):
        assert tuple(tp[k].shape) == tuple(jp[k].shape)
        np.testing.assert_allclose(_t(tp[k]), _t(jp[k]), **TOL)


def test_decode_steps_per_slot_positions_match(pair):
    """Two sequences at different positions decode together for four steps;
    both packages are fed the same (JAX-greedy) tokens."""
    jcfg, jparams, cfg, model = pair
    rng = np.random.default_rng(1)
    lens, max_seq = (7, 11), 24
    jcaches, tcaches, first = [], [], []
    for L in lens:
        toks = rng.integers(0, cfg.vocab, size=(1, L)).astype(np.int32)
        jl, jc = jax_prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
        tl, tc = tm.prefill(model, {"tokens": torch.from_numpy(toks)}, cfg)
        jcaches.append(jax_prime_cache(jcfg, jc, L, max_seq))
        tcaches.append(prime_cache(cfg, tc, L, max_seq))
        first.append(int(jnp.argmax(jl[0, -1])))
    jcache = {k: jnp.concatenate([c[k] for c in jcaches], axis=1) for k in ("k", "v")}
    tcache = {k: torch.cat([c[k] for c in tcaches], dim=1) for k in ("k", "v")}
    tok = np.asarray(first, np.int32)[:, None]
    for step in range(4):
        pos = np.asarray([L + step for L in lens], np.int32)
        jl, jcache = jax_decode_step(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos), jcfg)
        tl, tcache = tm.decode_step(model, torch.from_numpy(tok), tcache, torch.from_numpy(pos), cfg)
        np.testing.assert_allclose(_t(tl), _t(jl), **TOL)
        tok = np.array(jnp.argmax(jl[:, 0], axis=-1), np.int32)[:, None]
    for k in ("k", "v"):
        np.testing.assert_allclose(_t(tcache[k]), _t(jcache[k]), **TOL)


def test_decode_scalar_pos_equals_vector_pos():
    _, _, cfg, model = _deepseek_pair()
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 6)).astype(np.int32))
    _, c = tm.prefill(model, {"tokens": toks}, cfg)
    a = prime_cache(cfg, c, 6, 16)
    b = {k: v.clone() for k, v in a.items()}
    nxt = torch.tensor([[3], [5]], dtype=torch.int32)
    la, a = tm.decode_step(model, nxt, a, 6, cfg)
    lb, b = tm.decode_step(model, nxt, b, torch.tensor([6, 6], dtype=torch.int32), cfg)
    assert torch.equal(la, lb)
    assert all(torch.equal(a[k], b[k]) for k in ("k", "v"))


def _deepseek_pair():
    jcfg, cfg = CONFIGS["deepseek-7b"]
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, model


def test_bf16_bridge_round_trip_is_bit_exact():
    jcfg = jax_reduced_config("deepseek-7b")  # bfloat16 weights
    cfg = reduced_config("deepseek-7b")
    jparams = jax_init_params(jax.random.PRNGKey(3), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    model = params_from_numpy(tree, cfg, device="cpu")
    assert model.embedding.dtype == torch.bfloat16
    got = model.layers[1].attn.wq.view(torch.int16).numpy().view(np.uint16)
    want = tree["layers"]["attn"]["wq"][1].view(np.uint16)
    np.testing.assert_array_equal(got, want)
    for arr in (tree["embedding"], tree["layers"]["mlp"]["wo"]):
        t = tensor_from_numpy(arr)
        np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), arr.view(np.uint16))


def test_bridge_rejects_incomplete_tree():
    jcfg, cfg = CONFIGS["deepseek-7b"]
    tree = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    del tree["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(tree, cfg, device="cpu")


def test_init_params_follows_repro_init_rules():
    """Seeded draws, the ``init_tree`` rules: embed std 1, normal with
    1/sqrt(fan_in), zeros for the norm offsets and biases."""
    cfg = reduced_config("qwen1.5-110b").replace(dtype="float32", d_model=256, vocab=512)
    a = tm.init_params(cfg, 7, device="cpu")
    b = tm.init_params(cfg, 7, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert abs(float(a.embedding.std()) - 1.0) < 0.05
    wq = a.layers[0].attn.wq  # (D, H, Dh): fan_in D
    assert abs(float(wq.std()) * 256**0.5 - 1.0) < 0.05
    assert float(a.layers[1].ln2.scale.abs().max()) == 0.0
    assert float(a.layers[1].attn.bq.abs().max()) == 0.0
    assert a.embedding.dtype == torch.float32


def test_other_block_kinds_name_their_roadmap_item():
    """Every config in ``configs/`` builds: its ParamDef tree, the full
    model on the ``meta`` device (shapes alone) and a reduced model on the
    CPU whose parameters are the defs' leaves, unstacked; nothing refuses
    a block kind or a frontend any more."""
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.models.param import ParamDef

    def leaves(defs):
        for v in defs.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)

    for name in ARCH_NAMES:
        full = tm.Transformer(get_config(name), device="meta")
        assert sum(p.numel() for p in full.parameters()) == sum(
            int(np.prod(d.shape)) for d in leaves(tm.model_defs(get_config(name))))
        cfg = reduced_config(name)
        defs = tm.model_defs(cfg)
        assert all(isinstance(d, ParamDef) for d in leaves(defs))
        model = tm.init_params(cfg, 0, device="cpu")
        assert sum(p.numel() for p in model.parameters()) == sum(int(np.prod(d.shape)) for d in leaves(defs))
