"""``remat="dots_saveable"``: each layer recomputed in the backward but for
the outputs of its matrix products, as ``jax.checkpoint_policies.
dots_saveable`` does in ``repro``.

The port's policy (``models.transformer.dots_saveable_policy``) keeps the
outputs of ``aten.mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` and recomputes
everything else.  A remat mode changes what is kept, never what is
computed, so the loss and every gradient are bit for bit those of
``"none"`` and ``"full"``.  Against ``repro`` (bridged weights, float32 on
the CPU) the loss is held within 1e-5 relative and each gradient within
1e-5 of its leaf's largest magnitude (float32 sums in other orders).
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import leaf_path  # noqa: E402
from repro_torch.runtime.train import build_train_step, init_train_state  # noqa: E402

pytestmark = pytest.mark.timeout(300)

ARCHS = ("deepseek-7b", "mamba2-130m", "qwen3-moe-235b-a22b", "recurrentgemma-9b", "minicpm3-4b",
         "hubert-xlarge", "internvl2-2b")
B, L = 2, 32


def _batch(cfg, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        mask = np.zeros((B, L), bool)
        mask[:, ::4] = True
        return {"embeds": rng.standard_normal((B, L, 512)).astype(np.float32), "mask": mask,
                "labels": rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)}
    lt = L - cfg.n_patches if cfg.frontend == "vision" else L
    toks = rng.integers(0, cfg.vocab, (B, lt + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "vision":
        out["patch_embeds"] = rng.standard_normal((B, cfg.n_patches, 1024)).astype(np.float32)
    return out


def _pair(arch: str):
    jcfg = jax_reduced_config(arch).replace(dtype="float32")
    cfg = reduced_config(arch).replace(dtype="float32")
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    model = tm.set_trainable(params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return jcfg, cfg, jparams, model


def _loss_and_grads(model, cfg, batch: dict):
    loss, _ = tm.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_saveable_is_bitwise_none_and_full(arch):
    """The same loss and gradients, bit for bit, under ``"none"``,
    ``"full"`` and ``"dots_saveable"``: dense, ssm, MoE, the hybrid, MLA and
    both frontends (reduced, float32)."""
    _, cfg, _, model = _pair(arch)
    batch = _batch(cfg)
    want_loss, want = _loss_and_grads(model, cfg.replace(remat="none"), batch)
    for remat in ("full", "dots_saveable"):
        loss, grads = _loss_and_grads(model, cfg.replace(remat=remat), batch)
        assert torch.equal(loss, want_loss), remat
        for (n, _), g, w in zip(model.named_parameters(), grads, want):
            assert torch.equal(g, w), (remat, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_saveable_matches_repro(arch):
    """Loss within 1e-5 relative and every gradient within 1e-5 of its
    leaf's largest magnitude against ``repro``'s ``remat="dots_saveable"``
    (``jax.checkpoint`` with ``dots_saveable``)."""
    jcfg, cfg, jparams, model = _pair(arch)
    jcfg, cfg = jcfg.replace(remat="dots_saveable"), cfg.replace(remat="dots_saveable")
    batch = _batch(cfg)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg), has_aux=True)(jparams)
    loss, grads = _loss_and_grads(model, cfg, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    flat, _ = jax.tree_util.tree_flatten_with_path(jgrads)
    want = {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf in flat}
    for (n, _), g in zip(model.named_parameters(), grads):
        path, layer = leaf_path(n, model.leaf_layout)
        w = want[path] if layer is None else want[path][layer]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max() + 1e-12, err_msg=n)


def _saved_bytes(model, cfg, batch: dict, monkeypatch) -> tuple[int, dict]:
    """Bytes the forward leaves for the backward: the activations packed
    through ``saved_tensors_hooks`` (a checkpointed region packs its inputs
    there, and its own tensors into its frame) plus what the selective
    checkpoint's storage keeps, parameters excluded; and the ops that
    storage kept, by name."""
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    seen: dict = {}
    stores: list = []
    make = transformer.create_selective_checkpoint_contexts

    def capture(policy):
        fwd, rec = make(policy)
        stores.append(fwd.storage)
        return fwd, rec

    monkeypatch.setattr(transformer, "create_selective_checkpoint_contexts", capture)

    def keep(t):
        if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in params:
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(keep, lambda t: t):
        loss, _ = tm.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    kept_ops: dict = {}
    for storage in stores:  # op → its outputs, kept ones wrapped (others a recompute marker)
        for op, entries in storage.items():
            for out in entries.values():
                kept = [leaf.val for leaf in tree_leaves(out) if hasattr(leaf, "val")]
                if kept:
                    name = str(op.overloadpacket)
                    kept_ops[name] = kept_ops.get(name, 0) + 1
                for t in kept:
                    keep(t)
    del loss
    return sum(seen.values()), kept_ops


@pytest.mark.parametrize("arch", ["deepseek-7b", "hubert-xlarge"])
def test_dots_saveable_keeps_the_products(arch, monkeypatch):
    """Counted through ``saved_tensors_hooks`` and the selective
    checkpoint's storage: ``"dots_saveable"`` keeps only matrix products'
    outputs inside the layers, at least the 7 projections of each layer
    (q, k, v, o and the MLP's; hubert's GELU MLP has 2), so it saves more
    than ``"full"`` and less than ``"none"``."""
    _, cfg, _, model = _pair(arch)
    batch = _batch(cfg)
    sizes = {r: _saved_bytes(model, cfg.replace(remat=r), batch, monkeypatch) for r in ("none", "full",
                                                                                        "dots_saveable")}
    (none, _), (full, full_ops), (dots, dots_ops) = sizes["none"], sizes["full"], sizes["dots_saveable"]
    assert full_ops == {}
    assert set(dots_ops) <= {str(op) for op in transformer.DOT_OPS}, dots_ops
    per_layer = 4 + (3 if cfg.act in ("swiglu", "geglu") else 2)
    assert sum(dots_ops.values()) >= per_layer * cfg.n_layers, dots_ops
    assert full < dots < none, (full, dots, none)


def test_dots_saveable_trains_like_full():
    """Two staged train steps (2 microbatches) under each mode from the
    same state: losses, grad norms and every parameter after them bit for
    bit equal."""
    cfg = reduced_config("deepseek-7b").replace(dtype="float32")
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 17)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    runs = {}
    for remat in ("full", "dots_saveable"):
        c = cfg.replace(remat=remat)
        state = init_train_state(c, 0, device="cpu")
        art = build_train_step(c, n_microbatches=2)
        metrics = []
        for _ in range(2):
            state, m = art(state, batch)
            metrics.append((m["loss"].clone(), m["grad_norm"].clone()))
        runs[remat] = (metrics, [p.detach().clone() for p in state.params.parameters()])
    for a, b in zip(runs["full"][0], runs["dots_saveable"][0]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(runs["full"][1], runs["dots_saveable"][1]))
