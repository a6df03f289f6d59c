"""The ``model`` mesh axis: tensor-parallel dense training with sharded
parameters and optimizer state, checkpoint restore onto another mesh, and
the elastic re-mesh.

* the specs: ``param_shardings`` equals ``repro``'s ``safe_spec`` over
  ``repro.models.model_defs`` for every config at (data=4, model=2) and
  (data=16, model=16); a meta build holds exactly the local shapes;
* 2 spawned gloo processes on a (1, 2) data × model mesh: the local init
  is bit for bit the off-mesh init's slice; the tensor-parallel step
  (reduced deepseek-7b, fp32) against one off-mesh process for AdamW,
  Adafactor, int8 compression, the GQA / ``qk_norm`` / QKV-bias / tied /
  padded-vocab variant, an unsharded (odd) vocab, and the chunked
  cross-entropy over 2 microbatches; against ``repro``'s
  unsharded step on bridged weights; each rank's state bytes; an off-mesh
  checkpoint restored onto the mesh; the serving engine refused (prefill
  runs: tests/test_torch_tp_serve.py);
* 4 spawned processes on (2, 2): the step against one process, then
  ``launch.train.train_loop`` saving every 2 steps, losing 2 ranks after
  step 3, re-meshing to ``remesh_plan(4, 2, model_parallel=2)``'s (1, 2),
  restoring step 2 and running to step 4: equal to an unbroken run; that
  step-2 checkpoint restored off-mesh;
* two ``spawn_mesh`` groups started at once from two threads (F4);
* on the card (marked ``cuda``): two gloo processes share it at model=2.

Rank functions are module-level (the children unpickle them by importing
this file), and JAX is imported only inside the tests that use it.
"""
from __future__ import annotations

import functools
import math
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config, reduced_config  # noqa: E402
from repro_torch.dist.fault import remesh_plan  # noqa: E402
from repro_torch.dist.sharding import PartitionSpec, use_mesh  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import mesh as lm  # noqa: E402
from repro_torch.models import Transformer, model_defs, param_shardings  # noqa: E402
from repro_torch.models.param import ParamDef, local_shape  # noqa: E402
from repro_torch.optim import TrainState  # noqa: E402


class FakeMesh:
    """A mesh-like object: the axis sizes, no process group."""

    def __init__(self, **sizes):
        self.shape = sizes


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# The specs (no process group).
# ---------------------------------------------------------------------------

MESHES = {"data4-model2": dict(data=4, model=2), "data16-model16": dict(data=16, model=16)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_shardings_equal_repro(arch, mesh):
    from repro.configs import get_config as jax_get_config
    from repro.dist.sharding import safe_spec as jax_safe_spec
    from repro.models import model_defs as jax_model_defs

    fake = FakeMesh(**MESHES[mesh])
    want = {k: tuple(jax_safe_spec(d.shape, d.axes, mesh=fake))
            for k, d in _flat(jax_model_defs(jax_get_config(arch))).items()}
    got = {k: tuple(s) for k, s in _flat(param_shardings(get_config(arch), fake)).items()}
    assert got == want


def test_meta_build_holds_the_local_shapes():
    """Full-width deepseek-7b and qwen1.5-110b (8 KV heads: replicated at
    model=16) built on the meta device under a (data=16, model=16) mesh:
    every parameter at its local shape, the sharded ones 1/16 of the
    elements."""
    fake = FakeMesh(data=16, model=16)
    for arch in ("deepseek-7b", "qwen1.5-110b"):
        cfg = get_config(arch)
        with use_mesh(fake):
            model = Transformer(cfg, device="meta")
        assert model.tp is not None and model.tp.size == 16
        params = dict(model.named_parameters())
        n_sharded = 0
        for name, sh in model.shards.items():
            assert sh.index is None  # a mesh-like object has no ranks
            assert tuple(params[name].shape) == local_shape(sh.full, sh.spec, fake), name
            if sh.sharded:
                n_sharded += 1
                assert params[name].numel() * 16 == math.prod(sh.full), name
        assert n_sharded > 0
        kv = model.layers[0].attn
        assert kv.kv_sharded == (cfg.n_kv_heads % 16 == 0)


def test_other_block_kinds_and_frontends_raise_on_a_model_axis():
    """The SSM and RG-LRU block kinds, the hybrid layout and the frontends
    (once refused here, naming Queue 1 item 5.6) build on a model axis of
    2, their parameters at their parts of ``repro``'s ``param_shardings``,
    and so do the MoE and MLA configs (``tests/test_torch_tp_moe_mla.py``
    and ``tests/test_torch_tp_ssm_rec_frontends.py`` run them)."""
    from repro.dist.sharding import safe_spec as jax_safe_spec
    from repro.models.transformer import model_defs as jax_model_defs
    from repro_torch.models import param_shardings
    from repro_torch.runtime.train import build_train_step

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}/{k}").items()}
        return {prefix: tree}

    fake = FakeMesh(data=1, model=2)
    for arch in ("mamba2-130m", "recurrentgemma-9b", "hubert-xlarge", "internvl2-2b"):
        from repro.configs import reduced_config as jax_reduced_config

        cfg = reduced_config(arch)  # an unknown name raises: every arch here is checked
        with use_mesh(fake):
            model = Transformer(cfg, device="meta")
            build_train_step(cfg)
        assert model.tp.size == 2 and any(sh.sharded for sh in model.shards.values())
        want = {k: tuple(jax_safe_spec(d.shape, d.axes, mesh=fake))
                for k, d in flat(jax_model_defs(jax_reduced_config(arch))).items()}
        assert {k: tuple(v) for k, v in flat(param_shardings(cfg, fake)).items()} == want, arch
    for arch in ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e", "minicpm3-4b"):
        with use_mesh(FakeMesh(data=1, model=2)):
            assert Transformer(reduced_config(arch), device="meta").tp.size == 2
    with use_mesh(FakeMesh(data=2, model=1)):  # a model axis of 1 is no model axis
        assert Transformer(reduced_config("mamba2-130m"), device="meta").tp is None


def test_train_state_shardings_and_abstract_state():
    from repro_torch.runtime.train import abstract_train_state, train_state_shardings

    fake = FakeMesh(data=4, model=2)
    for opt in ("adamw", "adafactor"):
        cfg = reduced_config("deepseek-7b").replace(optimizer=opt)
        sh = train_state_shardings(cfg, fake)
        ab = abstract_train_state(cfg)
        p_specs = _flat(sh.params)
        assert set(p_specs) == set(_flat(ab.params))
        assert p_specs["layers/attn/wq"] == PartitionSpec(None, None, "model", None)
        assert p_specs["layers/mlp/wo"] == PartitionSpec(None, "model", None)
        assert p_specs["embedding"] == PartitionSpec("model", None)
        o_specs = _flat(sh.opt)
        assert set(o_specs) == set(_flat(ab.opt))
        if opt == "adamw":  # m / v mirror the parameters
            assert all(o_specs[f"{k}/{n}"] == s for k in ("m", "v") for n, s in p_specs.items())
        else:  # adafactor's state is replicated, as repro's
            assert all(s == PartitionSpec() for s in o_specs.values())
            assert tuple(_flat(ab.opt)["layers/attn/wq/vr"].shape) == (2, 64, 4)
        assert sh.step == PartitionSpec() and ab.step.dtype == torch.int32


# ---------------------------------------------------------------------------
# 2 spawned gloo processes: a (1, 2) data x model mesh.
# ---------------------------------------------------------------------------

def _odd_vocab():
    """A vocab the model axis cannot divide (101, unpadded): the embedding
    and logits stay replicated."""
    return lm.tp_config().replace(vocab=101, vocab_pad_multiple=1)


STEP_CASES = {  # name -> (tp_config's arguments, or a config; tp_train's keywords)
    "adamw": (("dense", "adamw"), {}),
    "adafactor": (("dense", "adafactor"), {}),
    "adamw-int8": (("dense", "adamw"), {"grad_compression": True}),
    "gqa-adamw": (("gqa", "adamw"), {}),
    "gqa-adafactor": (("gqa", "adafactor"), {}),
    "odd-vocab": (_odd_vocab, {}),
    # the logits in chunks of 8 (recomputed in the backward) and 2 microbatches
    "chunked-2mb": (lambda: lm.tp_config("dense", "adafactor").replace(logits_chunk=8), {"n_microbatches": 2}),
}


def _case_cfg(name):
    args, _ = STEP_CASES[name]
    return args() if callable(args) else lm.tp_config(*args)


def _state_parts(state) -> dict:
    """A state's local parts as numpy: parameters, optimizer state (by its
    key path) and the shards."""
    sh = state.params.shards
    return {"params": {n: p.detach().numpy().copy() for n, p in state.params.named_parameters()},
            "opt": {k: v.detach().numpy().copy() for k, v in _flat(state.opt).items()},
            "shards": {n: None if sh is None else (sh[n].full, sh[n].index) for n, _ in state.params.named_parameters()},
            "step": int(state.step)}


def _two_rank_cases(ckpt_dir, repro_pack):
    """Everything the (1, 2) mesh checks, in one process group."""
    from repro_torch.bridge import train_state_from_numpy
    from repro_torch.models import init_params, prefill
    from repro_torch.runtime.train import build_train_step
    from repro_torch.serving import ServeEngine

    out = {"init": {}, "steps": {}, "refused": []}
    for variant in ("dense", "gqa"):
        cfg = lm.tp_config(variant)
        local = init_params(cfg, 0, device="cpu")
        with use_mesh(None):
            whole = dict(init_params(cfg, 0, device="cpu").named_parameters())
        out["init"][variant] = [n for n, p in local.named_parameters()
                                if not torch.equal(p, whole[n][local.shards[n].index])]
    for name, (_, kw) in STEP_CASES.items():
        out["steps"][name] = lm.tp_train("cpu", _case_cfg(name), **kw)
    # an off-mesh checkpoint restored onto this mesh
    cfg = lm.tp_config("dense", "adamw")
    template = TrainState(step=torch.zeros((), dtype=torch.int32), params=Transformer(cfg, device="meta"), opt=None)
    _, restored = CheckpointManager(ckpt_dir).restore(template)
    out["restored"] = _state_parts(restored)
    # prefill runs on the mesh; the serving engine takes none, as repro's
    model = restored.params
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    for what, call in (("prefill", lambda: prefill(model, {"tokens": tokens}, cfg)),
                       ("ServeEngine", lambda: ServeEngine(cfg, model, device="cpu"))):
        try:
            call()
        except NotImplementedError as e:
            if "takes no mesh" in str(e):
                out["refused"].append(what)
    # repro's state, bridged: its whole leaves are cut to this rank's parts
    p_tree, o_tree, step, batches, rcfg = repro_pack
    state = train_state_from_numpy(p_tree, o_tree, step, rcfg, device="cpu")
    art = build_train_step(rcfg)
    metrics = []
    for b in batches:
        state, m = art(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    out["repro"] = {"metrics": metrics, **_state_parts(state)}
    return out


def _repro_pack():
    """repro's reduced deepseek-7b (fp32, Adafactor) initial state as numpy
    trees, three batches of its data stream, the port's copy of its config."""
    import dataclasses

    import jax

    from repro.configs import reduced_config as jax_reduced_config
    from repro.data import SyntheticLMDataset as JaxDataset
    from repro.models.config import ShapeSpec as JaxShape
    from repro.runtime.train import init_train_state as jax_init_train_state
    from repro_torch.models.config import ArchConfig

    jcfg = jax_reduced_config("deepseek-7b").replace(dtype="float32", optimizer="adafactor")
    js = jax_init_train_state(jax.random.PRNGKey(0), jcfg)
    ds = JaxDataset(jcfg, JaxShape("t", "train", 32, 4), seed=0)
    batches = [ds.batch_for_step(i) for i in range(3)]
    return (jax.tree.map(np.asarray, js.params), jax.tree.map(np.asarray, js.opt), int(js.step), batches,
            ArchConfig(**dataclasses.asdict(jcfg))), (jcfg, js)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    from repro_torch.runtime.train import build_train_step, init_train_state

    # an off-mesh AdamW state after 2 steps, saved
    cfg = lm.tp_config("dense", "adamw")
    state = init_train_state(cfg, 0, device="cpu")
    art = build_train_step(cfg)
    tokens = torch.randint(0, cfg.vocab, (4, 17), generator=torch.Generator().manual_seed(3), dtype=torch.int32)
    for _ in range(2):
        state, _ = art(state, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
    d = str(tmp_path_factory.mktemp("offmesh"))
    CheckpointManager(d).save(2, state, block=True)
    pack, jax_side = _repro_pack()
    ranks = lm.spawn_mesh(functools.partial(_two_rank_cases, d, pack), 2, (1, 2), ("data", "model"), timeout=150.0)
    return {"ranks": ranks, "saved": _state_parts(state), "jax": jax_side, "cfg": cfg}


def test_local_init_is_the_slice_of_the_off_mesh_init(two_ranks):
    for r in two_ranks["ranks"]:
        assert r["init"] == {"dense": [], "gqa": []}


# Parameters are held within 1e-6 of one process, except two AdamW cases.
# AdamW's update m / (sqrt(v) + eps) does not scale with the gradient: an
# element whose gradient sums to float noise moves by a fraction of the
# step's lr (3e-4) differently in a run whose sums are ordered otherwise
# (here: the row-parallel products and the vocab-parallel softmax summed over
# two ranks).  Observed: 2.5e-7 dense (2.8e-7 on (2, 2)), 1.2e-7 with int8
# compression, 1.2e-7 for every Adafactor case, but 3.7e-6 in the GQA
# variant's wo (at an element whose gradient was 5e-7 of a leaf max of 0.19)
# and 1.3e-6 in the odd vocab's embedding: those two are held within about
# three times their reading.  With int8 compression an element within float
# noise of a half step of the int8 grid rounds to neighbouring integers: the
# grad norm moves by up to |g_i| · scale / |g| (observed 4.5e-6 relative), so
# it is held within 1e-5 there.
PARAM_ATOL = {"gqa-adamw": 1e-5, "odd-vocab": 4e-6}
GRAD_NORM_RTOL = {"adamw-int8": 1e-5}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_tp_step_matches_one_process(two_ranks, case):
    """Two steps on the (1, 2) mesh against one off-mesh process: losses
    and grad norms within 1e-6 relative, gathered parameters within the
    case's tolerance (above), replicated parameters bit for bit equal
    on the two ranks."""
    ranks = [r["steps"][case] for r in two_ranks["ranks"]]
    cfg = _case_cfg(case)
    one = lm.tp_train("cpu", cfg, **STEP_CASES[case][1])
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-6)
        np.testing.assert_allclose(r["grad_norms"], one["grad_norms"], rtol=GRAD_NORM_RTOL.get(case, 1e-6))
    full = lm.gather_params(ranks)
    assert set(full) == set(one["params"])
    for n, p in one["params"].items():
        np.testing.assert_allclose(full[n], p, rtol=0, atol=PARAM_ATOL.get(case, 1e-6), err_msg=n)
    for n in lm.replicated_names(ranks[0]):
        np.testing.assert_array_equal(ranks[1]["params"][n], ranks[0]["params"][n], err_msg=n)
    if case == "odd-vocab":  # nothing of the vocab is sharded: the same loss either way
        assert lm.replicated_names(ranks[0]).count("embedding") == 1


def _expected_bytes(cfg, m: int) -> int:
    """fp32 bytes of every parameter's local part on a model axis of m."""
    fake = FakeMesh(data=1, model=m)
    specs = _flat(param_shardings(cfg, fake))
    defs = _flat(model_defs(cfg))
    return sum(4 * math.prod(local_shape(defs[k].shape, specs[k], fake)) for k in defs)


@pytest.mark.parametrize("case", ["adamw", "adafactor", "gqa-adamw"])
def test_state_bytes_are_the_local_shapes(two_ranks, case):
    cfg = _case_cfg(case)
    want = _expected_bytes(cfg, 2)
    assert want < _expected_bytes(cfg, 1)
    for r in two_ranks["ranks"]:
        got = r["steps"][case]["bytes"]
        assert got["params"] == want and got["grads"] == want
        if cfg.optimizer == "adamw":  # m and v: the parameters' parts
            assert got["opt"] == 2 * want
        # every model-sharded parameter holds half its elements
        for n, (full, index) in r["steps"][case]["shards"].items():
            part = r["steps"][case]["params"][n]
            if part.shape != tuple(full):
                assert part.size * 2 == math.prod(full), n


def test_off_mesh_checkpoint_restores_onto_the_mesh(two_ranks):
    """An AdamW state saved off-mesh: each rank restores its parts of the
    parameters and of m / v, bit for bit."""
    saved = two_ranks["saved"]
    ranks = [r["restored"] for r in two_ranks["ranks"]]
    assert all(r["step"] == 2 for r in ranks)
    full = lm.gather_params(ranks)
    for n, p in saved["params"].items():
        np.testing.assert_array_equal(full[n], p, err_msg=n)
    for key, w in saved["opt"].items():  # "m/<name>" / "v/<name>"
        name = key.split("/", 1)[1]
        parts = [{"params": {name: r["opt"][key]}, "shards": {name: r["shards"][name]}} for r in ranks]
        np.testing.assert_array_equal(lm.gather_params(parts)[name], w, err_msg=key)


def test_serving_refuses_a_model_axis(two_ranks):
    """``prefill`` runs on the mesh (tests/test_torch_tp_serve.py); the
    serving engine, which takes no mesh in ``repro`` either, refuses it."""
    for r in two_ranks["ranks"]:
        assert r["refused"] == ["ServeEngine"]


def test_tp_step_matches_repro_on_bridged_weights(two_ranks):
    """Three Adafactor steps from ``repro``'s init, bridged onto the (1, 2)
    mesh, against ``repro``'s unsharded ``build_train_step``: loss and grad
    norm within 1e-4 relative, parameters within 1e-6 (the tolerances of
    tests/test_torch_train.py)."""
    import jax
    import jax.numpy as jnp

    from repro.data import SyntheticLMDataset as JaxDataset
    from repro.models.config import ShapeSpec as JaxShape
    from repro.runtime.train import build_train_step as jax_build_train_step

    jcfg, js = two_ranks["jax"]
    jart = jax_build_train_step(jcfg, donate=False)
    ds = JaxDataset(jcfg, JaxShape("t", "train", 32, 4), seed=0)
    for i in range(3):
        js, jm = jart(js, {k: jnp.asarray(v) for k, v in ds.batch_for_step(i).items()})
        for r in two_ranks["ranks"]:
            for key in ("loss", "ce_loss", "grad_norm"):
                np.testing.assert_allclose(r["repro"]["metrics"][i][key], float(jm[key]), rtol=1e-4)
    from repro_torch.optim import leaf_path

    full = lm.gather_params([r["repro"] for r in two_ranks["ranks"]])
    want = jax.tree.map(np.asarray, js.params)
    for n, p in full.items():
        path, layer = leaf_path(n)
        w = want
        for k in path.split("/"):
            w = w[k]
        np.testing.assert_allclose(p, w if layer is None else w[layer], rtol=0, atol=1e-6, err_msg=n)


# ---------------------------------------------------------------------------
# 4 spawned gloo processes: (2, 2), then the re-mesh to (1, 2).
# ---------------------------------------------------------------------------

REMESH_STEPS = 4


def _loop(cfg, ckpt_dir, fail):
    """``launch.train.train_loop`` from the seeded state, saving every 2
    steps; ``fail`` loses ranks ({step: n})."""
    from repro_torch.dist.fault import FailureSimulator
    from repro_torch.launch.train import train_loop
    from repro_torch.runtime.train import init_train_state

    recoveries = []
    state, losses = train_loop(cfg, init_train_state(cfg, 0, device="cpu"), steps=REMESH_STEPS, batch=4, seq=16,
                               microbatches=1, mgr=CheckpointManager(ckpt_dir, keep=5), ckpt_every=2,
                               sim=FailureSimulator(fail) if fail else None, recovery="restore",
                               recoveries=recoveries)
    if state is None:
        return {"left": True, "losses": losses}
    return {"left": False, "losses": losses, "recoveries": recoveries, **_state_parts(state)}


def _four_rank_cases(ckpt_dir):
    out = {name: lm.tp_train("cpu", _case_cfg(name)) for name in ("adamw", "adafactor")}
    out["loop"] = _loop(lm.tp_config("dense", "adafactor"), ckpt_dir, {3: 2})
    return out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("remesh"))
    ranks = lm.spawn_mesh(functools.partial(_four_rank_cases, d), 4, (2, 2), ("data", "model"), timeout=150.0)
    return {"ranks": ranks, "dir": d}


@pytest.mark.parametrize("case", ["adamw", "adafactor"])
def test_tp_step_on_data_x_model_matches_one_process(four_ranks, case):
    ranks = [r[case] for r in four_ranks["ranks"]]
    one = lm.tp_train("cpu", _case_cfg(case))
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-6)
        np.testing.assert_allclose(r["grad_norms"], one["grad_norms"], rtol=1e-6)
    for rows in (ranks[:2], ranks[2:]):  # each data row of the mesh holds the whole model
        full = lm.gather_params(rows)
        for n, p in one["params"].items():
            np.testing.assert_allclose(full[n], p, rtol=0, atol=PARAM_ATOL.get(case, 1e-6), err_msg=n)
    for n in lm.replicated_names(ranks[0]):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["params"][n], ranks[0]["params"][n], err_msg=n)


def test_remesh_restores_onto_the_smaller_mesh_and_equals_an_unbroken_run(four_ranks, tmp_path):
    """Ranks 2 and 3 leave after step 3; ranks 0 and 1 re-mesh to (1, 2),
    restore step 2 (written on (2, 2)) and run to step 4: the losses and
    parameters of an unbroken off-mesh run within 1e-6."""
    plan = remesh_plan(4, 2, model_parallel=2)
    assert (plan.shape, plan.axes) == ((1, 2), ("data", "model"))
    loops = [r["loop"] for r in four_ranks["ranks"]]
    assert [r["left"] for r in loops] == [False, False, True, True]
    for r in loops[:2]:
        assert r["step"] == REMESH_STEPS
        assert [(x["mode"], x["step"], x["mesh"]) for x in r["recoveries"]] == \
            [("restore", 2, {"data": 1, "model": 2})]
    one = _loop(lm.tp_config("dense", "adafactor"), str(tmp_path), None)
    for r in loops[:2]:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-6)
    full = lm.gather_params(loops[:2])
    for n, p in one["params"].items():
        np.testing.assert_allclose(full[n], p, rtol=0, atol=1e-6, err_msg=n)
    for k, w in one["opt"].items():  # Adafactor's state: whole, the same on both ranks
        np.testing.assert_array_equal(loops[0]["opt"][k], loops[1]["opt"][k], err_msg=k)
        np.testing.assert_allclose(loops[0]["opt"][k], w, rtol=0, atol=1e-6 * np.abs(w).max(), err_msg=k)


def test_mesh_checkpoint_restores_off_mesh(four_ranks, tmp_path):
    """The step-2 checkpoint written on (2, 2) (every shard once: the
    manifest lists the model-sharded leaves' two shards) restored off-mesh
    equals an unbroken off-mesh run's step 2 within 1e-6."""
    import json
    import os

    cfg = lm.tp_config("dense", "adafactor")
    d2 = os.path.join(four_ranks["dir"], "step_000000002")
    with open(os.path.join(d2, "MANIFEST.json")) as f:
        leaves = {e["path"]: e for e in json.load(f)["leaves"]}
    wq = leaves[".params/['layers']/['attn']/['wq']"]
    assert wq["spec"] == [[], [], ["model"], []] and len(wq["shards"]) == 2
    assert "file" in leaves[".params/['final_norm']"]  # replicated: one file
    assert len([f for f in os.listdir(d2) if f.endswith(".npy")]) == \
        sum(len(e.get("shards", [0])) for e in leaves.values())
    template = TrainState(step=torch.zeros((), dtype=torch.int32), params=Transformer(cfg, device="meta"), opt=None)
    step, got = CheckpointManager(four_ranks["dir"]).restore(template, step=2)
    _loop(cfg, str(tmp_path), None)
    _, want = CheckpointManager(str(tmp_path)).restore(template, step=2)
    assert step == 2 and got.params.tp is None
    g, w = _state_parts(got), _state_parts(want)
    for n, p in w["params"].items():
        np.testing.assert_allclose(g["params"][n], p, rtol=0, atol=1e-6, err_msg=n)
    for k, v in w["opt"].items():
        np.testing.assert_allclose(g["opt"][k], v, rtol=0, atol=1e-6 * np.abs(v).max(), err_msg=k)


# ---------------------------------------------------------------------------
# F4: the rendezvous port is the parent's.
# ---------------------------------------------------------------------------

def _rank_and_sum():
    import torch.distributed as dist

    t = torch.ones(1) * (dist.get_rank() + 1)
    dist.all_reduce(t)
    return (dist.get_rank(), float(t))


def test_two_spawn_mesh_groups_started_at_once_both_finish():
    results, errors = {}, []

    def run(i):
        try:
            results[i] = lm.spawn_mesh(_rank_and_sum, 2, (2,), ("data",), timeout=60.0)
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    assert not errors and results == {0: [(0, 3.0), (1, 3.0)], 1: [(0, 3.0), (1, 3.0)]}


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

def _card_rank():
    """Two steps of reduced deepseek-7b at model=2 with every tensor on the
    card; each rank's flash and rmsnorm launch counts."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops

    counters = {"flash": flash_ops.launches, "flash_bwd": flash_ops.bwd_launches,
                "rmsnorm": rmsnorm_ops.launches, "rmsnorm_bwd": rmsnorm_ops.bwd_launches}
    for c in counters.values():
        c.reset()
    out = lm.tp_train("cuda")
    return {"losses": out["losses"], "launches": {k: c.count for k, c in counters.items()}}


@pytest.mark.cuda
def test_two_gloo_processes_share_the_card_at_model_2():
    """Reduced deepseek-7b at model=2 on two gloo processes that share the
    card: the losses of one off-mesh process on the card within 1e-5, the
    flash and rmsnorm kernels launched on every rank."""
    if not dispatch.cuda_available():
        pytest.skip("needs an sm_90 CUDA card")
    ranks = lm.spawn_mesh(_card_rank, 2, (1, 2), ("data", "model"), timeout=300.0)
    one = lm.tp_train("cuda")  # off-mesh on the card: the same (card) generator's init
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
        assert all(n > 0 for n in r["launches"].values()), r["launches"]
