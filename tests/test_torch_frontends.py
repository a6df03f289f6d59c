"""The port's audio and vision frontends (hubert-xlarge, internvl2-2b)
against ``repro``'s, with the same weights and inputs.

``repro`` draws the weights (``jax.random``); ``repro_torch.bridge`` carries
them across (``frontend_proj``, ``mask_emb`` and ``head`` of the audio
model, ``patch_proj`` of the vision model, by name).  Inputs are drawn with
numpy from a seed, the shapes of ``repro``'s ``tests/test_models_smoke.py``
(B = 2, L = 32; every 4th audio frame masked; 4 patches before 28 text
tokens in the reduced vision config).  Everything runs in float32 on the
CPU, where the port's kernels are their plain versions (hubert's attention
is the non-causal path).

Tolerances: hidden states and the loss within 1e-5 relative, each gradient
within 1e-5 of its leaf's largest magnitude (float32 sums in other orders;
observed ≤ 1e-6); prefill and decode logits within 2e-4 (``repro``'s own
prefill-vs-forward tolerance); train-step parameters within
``test_torch_train.py``'s AdamW bound, 3e-5.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.data import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.models import abstract_inputs as jax_abstract_inputs  # noqa: E402
from repro.models import abstract_params as jax_abstract_params  # noqa: E402
from repro.models import applicable_shapes as jax_applicable_shapes  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models.config import ShapeSpec as JaxShape  # noqa: E402
from repro.runtime.serve import prime_cache as jax_prime_cache  # noqa: E402
from repro.runtime.train import build_train_step as jax_build_train_step  # noqa: E402
from repro.runtime.train import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.bridge import params_from_numpy, train_state_from_numpy, train_state_to_numpy  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config, reduced_config  # noqa: E402
from repro_torch.models.config import applicable_shapes  # noqa: E402
from repro_torch.optim import leaf_path  # noqa: E402
from repro_torch.runtime.serve import prime_cache  # noqa: E402
from repro_torch.runtime.train import build_train_step  # noqa: E402

pytestmark = pytest.mark.timeout(300)

AUDIO, VISION = "hubert-xlarge", "internvl2-2b"
FRONTENDS = (AUDIO, VISION)
B, L = 2, 32
REL = 1e-5


def _tree_leaves(tree: dict) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf in flat}


def _pair(arch: str, **over):
    """``repro``'s reduced float32 config, its weights, and the port's model
    built from them."""
    jcfg = jax_reduced_config(arch).replace(dtype="float32", **over)
    cfg = reduced_config(arch).replace(dtype="float32", **over)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    model = tm.set_trainable(params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return jcfg, cfg, jparams, model


def _batch(cfg, seed: int = 1, length: int = L) -> dict:
    """numpy inputs of ``repro``'s smoke-test shapes: audio frames with every
    4th masked, or ``n_patches`` patches and the rest text."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        mask = np.zeros((B, length), bool)
        mask[:, ::4] = True
        return {"embeds": rng.standard_normal((B, length, 512)).astype(np.float32), "mask": mask,
                "labels": rng.integers(0, cfg.vocab, (B, length)).astype(np.int32)}
    lt = length - cfg.n_patches
    return {"tokens": rng.integers(0, cfg.vocab, (B, lt)).astype(np.int32),
            "patch_embeds": rng.standard_normal((B, cfg.n_patches, 1024)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab, (B, lt)).astype(np.int32)}


def _jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close_rel(got, want, rel=REL, msg="") -> None:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max() + 1e-12, err_msg=msg)


def _grads_match(model, loss, jgrads, rel=REL) -> None:
    names, tensors = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, tensors)
    want = _tree_leaves(jgrads)
    seen = set()
    for n, g in zip(names, grads):
        path, layer = leaf_path(n)
        seen.add(path)
        w = want[path] if layer is None else want[path][layer]
        _close_rel(g.numpy(), w, rel, msg=n)
    assert seen == set(want), sorted(set(want) ^ seen)


# ---------------------------------------------------------------------------
# Parameters, forward, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_parameters_bridge_by_name(arch):
    """The port builds ``repro``'s frontend leaves, under the same names and
    shapes, and none it lacks: no embedding table for audio."""
    jcfg, cfg, jparams, model = _pair(arch)
    want = {k: v.shape for k, v in _tree_leaves(jparams).items() if not k.startswith("layers/")}
    got = {n: tuple(p.shape) for n, p in model.named_parameters() if not n.startswith("layers.")}
    assert {leaf_path(n)[0]: s for n, s in got.items()} == want
    if arch == AUDIO:
        assert set(got) == {"frontend_proj", "mask_emb", "head", "final_norm.scale"}
        assert not hasattr(model, "embedding")
    else:
        assert {"patch_proj", "embedding", "unembed"} <= set(got)
    assert model.device.type == "cpu"


@pytest.mark.parametrize("arch", FRONTENDS)
def test_forward_matches_repro(arch):
    """Hidden states (B, L, D) within 1e-5 of the largest magnitude: the
    audio model over every frame (non-causal), the vision model over
    patches then text."""
    jcfg, cfg, jparams, model = _pair(arch)
    batch = _batch(cfg)
    jx, _, _ = jax_forward(jparams, _jax(batch), jcfg)
    with torch.no_grad():
        x, _, aux = tm.forward(model, _torch(batch), cfg)
    assert x.shape == (B, L, cfg.d_model) and aux == {}
    _close_rel(x.numpy(), jx)


@pytest.mark.parametrize("chunk", [None, 7], ids=["whole", "chunked"])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_loss_and_grads_match_repro(arch, chunk):
    """The loss within 1e-5 relative and every gradient within 1e-5 of its
    leaf's largest magnitude, against ``jax.value_and_grad(repro.loss_fn)``:
    hubert's masked prediction through ``head`` (its 8 padding logits stay
    in the softmax, as in ``repro``), internvl's text slice with and without
    ``logits_chunk`` (28 text positions in chunks of 7; audio ignores the
    knob, as ``repro`` does)."""
    jcfg, cfg, jparams, model = _pair(arch, logits_chunk=chunk)
    batch = _batch(cfg)
    (jloss, _), jgrads = jax.value_and_grad(lambda p: jax_loss_fn(p, _jax(batch), jcfg), has_aux=True)(jparams)
    loss, metrics = tm.loss_fn(model, _torch(batch), cfg)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=REL)
    assert set(metrics) == {"ce_loss"}
    _grads_match(model, loss, jgrads)


def test_audio_padding_logits_stay_in_the_softmax():
    """A vocab of 120 pads to 128 classes: the audio loss keeps the 8
    padding logits in its softmax, as ``repro``'s does (no mask, no
    softcap), so it differs from the loss over the real classes alone;
    loss and gradients within 1e-5 of ``repro``'s."""
    jcfg, cfg, jparams, model = _pair(AUDIO, vocab=120)
    assert cfg.padded_vocab == 128
    batch = _batch(cfg)
    (jloss, _), jgrads = jax.value_and_grad(lambda p: jax_loss_fn(p, _jax(batch), jcfg), has_aux=True)(jparams)
    loss, _ = tm.loss_fn(model, _torch(batch), cfg)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=REL)
    with torch.no_grad():
        x, _, _ = tm.forward(model, _torch(batch), cfg)
        real = tm.head_logits(model, x, cfg)[..., :cfg.vocab]
        m = torch.from_numpy(batch["mask"])
        nll = torch.nn.functional.cross_entropy(real.permute(0, 2, 1), torch.from_numpy(batch["labels"]).long(),
                                                reduction="none")
        assert float(nll[m].mean()) < float(loss)
    _grads_match(model, loss, jgrads)


def test_audio_mask_substitutes_mask_emb():
    """Masked frames enter the layers as ``mask_emb``, whatever their frame
    embedding; the others as ``embeds @ frontend_proj``; without a mask every
    frame is projected."""
    _, cfg, _, model = _pair(AUDIO)
    batch = _torch(_batch(cfg))
    with torch.no_grad():
        x, pos = tm.embed_inputs(model, batch, cfg)
        proj = batch["embeds"] @ model.frontend_proj
        m = batch["mask"]
        assert torch.equal(x[m], model.mask_emb.expand(int(m.sum()), -1))
        assert torch.equal(x[~m], proj[~m])
        unmasked, _ = tm.embed_inputs(model, {k: v for k, v in batch.items() if k != "mask"}, cfg)
        assert torch.equal(unmasked, proj)
    assert torch.equal(pos, torch.arange(L, dtype=torch.int32).expand(B, L))


def test_audio_loss_counts_masked_frames_only():
    """The loss is the mean cross-entropy of the masked frames: labels of
    unmasked frames do not move it, and it equals the mean over the
    masked frames of the full logits' cross-entropy."""
    _, cfg, _, model = _pair(AUDIO)
    batch = _torch(_batch(cfg))
    with torch.no_grad():
        loss, _ = tm.loss_fn(model, batch, cfg)
        other = dict(batch, labels=torch.where(batch["mask"], batch["labels"], (batch["labels"] + 1) % cfg.vocab))
        assert torch.equal(tm.loss_fn(model, other, cfg)[0], loss)
        x, _, _ = tm.forward(model, batch, cfg)
        logits = tm.head_logits(model, x, cfg)
        assert logits.shape == (B, L, cfg.padded_vocab)
        nll = torch.nn.functional.cross_entropy(logits.permute(0, 2, 1), batch["labels"].long(), reduction="none")
        torch.testing.assert_close(loss, nll[batch["mask"]].mean(), rtol=1e-6, atol=0)


def test_vision_loss_reads_text_positions_only():
    """The vision loss slices the last ``labels.shape[1]`` positions: the
    same with and without ``logits_chunk``, and a change of the patches moves
    it only through attention (the patch positions carry no label)."""
    _, cfg, _, model = _pair(VISION)
    batch = _torch(_batch(cfg))
    with torch.no_grad():
        whole, _ = tm.loss_fn(model, batch, cfg)
        chunked, _ = tm.loss_fn(model, batch, cfg.replace(logits_chunk=4))
        torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=0)
        x, _, _ = tm.forward(model, batch, cfg)
        text = x[:, cfg.n_patches:]
        want = torch.nn.functional.cross_entropy(
            tm.head_logits(model, text, cfg).permute(0, 2, 1), batch["labels"].long())
        torch.testing.assert_close(whole, want, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="not divisible"):
        tm.loss_fn(model, batch, cfg.replace(logits_chunk=5))


# ---------------------------------------------------------------------------
# Serving: prefill and decode
# ---------------------------------------------------------------------------

def test_audio_prefill_is_the_last_frame_through_head():
    """hubert's prefill: the last frame's logits through ``head``, within
    2e-4 of ``repro``'s; an encoder has no decode shapes."""
    jcfg, cfg, jparams, model = _pair(AUDIO)
    batch = _batch(cfg)
    jl, _ = jax_prefill(jparams, {k: v for k, v in _jax(batch).items() if k != "labels"}, jcfg)
    lg, caches = tm.prefill(model, {k: v for k, v in _torch(batch).items() if k != "labels"}, cfg)
    assert lg.shape == (B, 1, cfg.padded_vocab) and caches["k"].shape[2] == L
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)
    assert not cfg.supports_decode
    assert [s.kind for s in applicable_shapes(cfg)] == ["train", "prefill"]


def test_vision_prefill_decode_matches_forward_and_repro():
    """internvl: prefill of 4 patches + 16 text tokens, ``prime_cache`` at
    ``n_patches + 16`` rows, then 3 teacher-forced decode steps at position
    ``n_patches + 16 + s``: each within 2e-4 of the port's full forward at
    that position and of ``repro``'s prefill and decode (the inputs of
    ``repro``'s ``tests/test_models_smoke.py``)."""
    jcfg, cfg, jparams, model = _pair(VISION)
    T0, STEPS, SMAX = 16, 4, 32
    full = _batch(cfg)
    tokens = full["tokens"]
    off = cfg.n_patches
    fb = {"tokens": tokens[:, :T0 + STEPS], "patch_embeds": full["patch_embeds"]}
    with torch.no_grad():
        x, _, _ = tm.forward(model, _torch(fb), cfg)
        logits_full = tm.head_logits(model, x, cfg)
    pb = {"tokens": tokens[:, :T0], "patch_embeds": full["patch_embeds"]}
    lg, caches = tm.prefill(model, _torch(pb), cfg)
    jl, jc = jax_prefill(jparams, _jax(pb), jcfg)
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(lg[:, 0].numpy(), logits_full[:, off + T0 - 1].numpy(), **tol)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **tol)
    caches = prime_cache(cfg, caches, off + T0, off + SMAX)
    jc = jax_prime_cache(jcfg, jc, off + T0, off + SMAX)
    assert caches["k"].shape == (cfg.n_layers, B, off + SMAX, cfg.n_kv_heads, cfg.head_dim)
    for s in range(STEPS - 1):
        pos = off + T0 + s
        tok = tokens[:, T0 + s:T0 + s + 1]
        lg, caches = tm.decode_step(model, torch.from_numpy(tok), caches, pos, cfg)
        jl, jc = jax_decode_step(jparams, jnp.asarray(tok), jc, jnp.int32(pos), jcfg)
        np.testing.assert_allclose(lg[:, 0].numpy(), logits_full[:, pos].numpy(), err_msg=f"step {s}", **tol)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), err_msg=f"step {s}", **tol)


# ---------------------------------------------------------------------------
# The staged train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_train_steps_match_repro(arch, optimizer):
    """Two steps of ``build_train_step`` (2 microbatches) from bridged state
    on ``SyntheticLMDataset``'s frontend batches: loss and grad norm within
    1e-5 relative at each step, then every parameter within 3e-5 (AdamW;
    Adafactor 1e-6, ``test_torch_train.py``'s bounds) and every optimizer
    leaf within 1e-5 of its largest magnitude (the 1-D ``mask_emb`` takes
    Adafactor's unfactored ``v``, as in ``repro``)."""
    jcfg = jax_reduced_config(arch).replace(dtype="float32", optimizer=optimizer)
    cfg = reduced_config(arch).replace(dtype="float32", optimizer=optimizer)
    js = jax_init_train_state(jax.random.PRNGKey(0), jcfg)
    st = train_state_from_numpy(jax.tree.map(np.asarray, js.params), jax.tree.map(np.asarray, js.opt), js.step,
                                cfg, "cpu")
    jart = jax_build_train_step(jcfg, n_microbatches=2, donate=False)
    art = build_train_step(cfg, n_microbatches=2)
    ds = JaxDataset(jcfg, JaxShape("t", "train", L, 4), seed=0)
    for step in range(2):
        b = ds.batch_for_step(step)
        js, jm = jart(js, _jax(b))
        st, m = art(st, _torch(b))
        for key in ("loss", "ce_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=REL, err_msg=f"{key} {step}")
    p_tree, o_tree, n = train_state_to_numpy(st)
    assert n == int(js.step) == 2
    want_p, got_p = _tree_leaves(jax.tree.map(np.asarray, js.params)), _tree_leaves(p_tree)
    assert sorted(want_p) == sorted(got_p)
    for k, w in want_p.items():
        np.testing.assert_allclose(got_p[k], w, rtol=0, atol={"adamw": 3e-5, "adafactor": 1e-6}[optimizer],
                                   err_msg=k)
    want_o, got_o = _tree_leaves(jax.tree.map(np.asarray, js.opt)), _tree_leaves(o_tree)
    assert sorted(want_o) == sorted(got_o)
    for k, w in want_o.items():
        np.testing.assert_allclose(got_o[k], w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)
    if optimizer == "adafactor":
        assert set(o_tree["mask_emb" if arch == AUDIO else "patch_proj"]) == (
            {"v"} if arch == AUDIO else {"vr", "vc"})


# ---------------------------------------------------------------------------
# Input specs and abstract trees
# ---------------------------------------------------------------------------

def _spec(t) -> tuple:
    """(shape, dtype name) of a meta tensor or a ShapeDtypeStruct."""
    name = str(t.dtype).replace("torch.", "")
    return tuple(t.shape), {"bool_": "bool"}.get(name, name)


SHAPE_CASES = [(a, s.name) for a in JAX_ARCH_NAMES for s in jax_applicable_shapes(jax_get_config(a))]


@pytest.mark.parametrize("arch,shape", SHAPE_CASES, ids=[f"{a}-{s}" for a, s in SHAPE_CASES])
def test_input_specs_match_repro(arch, shape):
    """``input_defs`` / ``abstract_inputs`` of every config and applicable
    shape: the same keys, shapes and dtypes as ``repro``'s, on ``meta``."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    spec = next(s for s in applicable_shapes(cfg) if s.name == shape)
    want = jax_abstract_inputs(jcfg, next(s for s in jax_applicable_shapes(jcfg) if s.name == shape))
    got = tm.abstract_inputs(cfg, spec)
    assert set(got) == set(want)
    for k in want:
        assert got[k].device.type == "meta"
        assert _spec(got[k]) == _spec(want[k]), k
    assert {k: d.shape for k, d in tm.input_defs(cfg, spec).items()} == {k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_params_match_repro(arch):
    """``abstract_params`` of every full config: ``repro``'s tree (layers
    stacked, a hybrid's super-blocks and tail), the same shapes and dtypes,
    as ``meta`` tensors; and ``Transformer(cfg, device="meta")`` holds the
    same parameters unstacked, so the bridge's names reach every leaf."""
    cfg = get_config(arch)
    flat, _ = jax.tree_util.tree_flatten_with_path(jax_abstract_params(jax_get_config(arch)))
    want = {"/".join(k.key for k in path): _spec(leaf) for path, leaf in flat}
    got_tree = tm.abstract_params(cfg)
    flat_t = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                assert v.device.type == "meta"
                flat_t["/".join(prefix + (k,))] = _spec(v)

    walk(got_tree, ())
    assert flat_t == want
    model = tm.Transformer(cfg, device="meta")
    assert model.device.type == "meta"
    seen = {}
    for n, p in model.named_parameters():
        path, layer = leaf_path(n, model.leaf_layout)
        shape = want[path][0] if layer is None else want[path][0][1:]
        assert tuple(p.shape) == shape, n
        seen[path] = seen.get(path, 0) + 1
    assert set(seen) == set(want)
    assert sum(p.numel() for p in model.parameters()) == sum(int(np.prod(s)) for s, _ in want.values())


def test_meta_device_builds_but_never_launches():
    """``meta`` passes for building a model; caches on ``meta`` come from
    ``abstract_cache`` alone, with ``init_cache``'s shapes and dtypes; a
    kernel wrapper given meta tensors takes its meta route (its output on
    ``meta``, no launch counted) and raises for meta mixed with another
    device, and ``cuda`` without a card still raises."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops

    caches = tm.abstract_cache(get_config(VISION), 4, 2304)
    assert caches["k"].shape == (24, 4, 2304, 8, 128) and caches["k"].device.type == "meta"
    small = reduced_config(VISION)
    made = tm.init_cache(small, 2, 64, device="cpu")
    assert ({k: (tuple(v.shape), v.dtype) for k, v in tm.abstract_cache(small, 2, 64).items()}
            == {k: (tuple(v.shape), v.dtype) for k, v in made.items()})
    with pytest.raises(ValueError, match="unsupported device"):
        tm.init_cache(small, 2, 64, device="meta")
    before = rmsnorm_ops.launches.count
    out = rmsnorm_ops.rmsnorm(torch.empty(3, 8, device="meta"), torch.empty(8, device="meta"))
    assert out.device.type == "meta" and out.shape == (3, 8) and rmsnorm_ops.launches.count == before
    with pytest.raises(ValueError, match="tensors on meta and cpu"):
        rmsnorm_ops.rmsnorm(torch.empty(3, 8, device="meta"), torch.empty(8))
    with pytest.raises(ValueError, match="unsupported device"):
        dispatch.resolve_device("meta")
    if not dispatch.cuda_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tm.Transformer(reduced_config(AUDIO), device="cuda")
