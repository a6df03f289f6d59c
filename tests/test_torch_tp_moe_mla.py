"""Mixture of experts and MLA on the ``model`` mesh axis: expert
parallelism (``experts`` over ``model``), column / row-parallel experts
where m does not divide the experts (``expert_ff``), MLA's heads over
``model`` with its row-sharded latent cache, and GQA whose heads m does
not divide beside a sequence-sharded cache — in training and in serving,
against one process of the port and against ``repro``.

* one module-scoped 2-rank (1, 2) and one 4-rank (1, 4) gloo group, each
  running every ``TRAIN_CASES`` and ``SERVE_CASES`` case from ``repro``'s
  weights (bridged: its whole leaves cut to each rank's parts), float32, 2
  layers: reduced qwen3-moe (4 experts top-2, einsum dispatch, QK norm, 4
  query heads on 1 KV head: expert parallelism, 2 or 1 experts a rank);
  reduced qwen3-moe with 3 experts and the scatter dispatch (m divides
  neither: ``expert_ff`` is sharded, column / row-parallel experts);
  reduced llama4-scout with 3 query heads (4 experts top-1 and the shared
  expert; heads m does not divide, whole on every rank beside a
  sequence-sharded KV cache); reduced minicpm3-4b (MLA, 4 heads over
  ``model``) and with 3 heads (whole on every rank, the latent cache
  sharded by rows);
* training: ``STEPS`` staged steps on ``repro``'s data stream with
  AdamW or Adafactor; each rank's loss, ``ce_loss``, grad norm and aux
  losses (``moe_balance``, ``moe_zloss``), every parameter's parts put
  together, AdamW's ``m`` / ``v`` parts and Adafactor's whole state
  against one process of the port from the same state and against
  ``repro``'s ``build_train_step``; replicated parameters and Adafactor's
  state the same bits on every rank; every router call's ``top_i`` the
  same bits on every rank;
* serving: four prompts (13 / 16 / 13 / 16 tokens: 13 gives a prompt
  cache that stays whole, 16 one sharded by rows) prefilled one by
  one and primed into 32-row caches, then 8 greedy ``build_serve_step``
  steps at per-slot positions that cross the ranks' rows; the tokens
  equal one process's and ``repro``'s, the logits within ``LOGIT_RTOL``
  of their row's largest, each rank's primed caches its slice of one
  process's, ``verify_step`` bit for bit the decode steps;
* a (2, 2) data × model group: the MoE routes over the global batch
  (its dispatch groups, capacity and load-balance means span the data
  rows, as GSPMD gives ``repro``), so each data row's steps equal one
  process's and ``repro``'s; it serves a batch of 3, which every data
  rank holds whole and routes alone, and one of 4 split over the data
  rows, each rank's tokens equal to one process's for its rows;
* an expert-sharded checkpoint (parameters and AdamW's ``m`` / ``v``)
  written on (1, 2) restored onto (1, 4) and off the mesh, bit for bit;
* the layouts: each layer's parts at m = 2 / 4 / 16 on a meta build,
  ``latent_part``, and ``cache_shardings`` of qwen3-moe, llama4-scout and
  minicpm3-4b equal to ``repro``'s on both production meshes;
* the refusals that stay: the SSM and RG-LRU block kinds, the hybrid
  layout and the frontends on a ``model`` axis name Queue 1 item 5.6.

Tolerances (float32; the readings are this file's runs on the CPU).
Against one process: the losses, aux losses and grad norms within
``METRIC_RTOL`` = 1e-6 relative (read: up to 3.2e-7: the ranks' narrower
products and their sums over ``model`` add in another order); parameters
within ``PARAM_ATOL``: 1e-6 after Adafactor (read 1.2e-7) and 5e-5 after
AdamW, whose m / (sqrt(v) + eps) does not scale with the gradient, so an
element whose gradient sums to float noise moves by a share of the step's
lr (3e-4) differently when the sums are ordered otherwise (read up to
1.6e-5, in qwen3-moe's expert weights, whose experts see few tokens;
``tests/test_torch_tp.py`` reads the same effect); the optimizer state
within ``STATE_RTOL`` = 1e-5 of its leaf's largest magnitude (read 2.1e-6:
v squares the gradients' noise).  Against ``repro`` (XLA's CPU products
and reductions): the metrics within 1e-4 relative (read 1.2e-6),
parameters within ``PARAM_ATOL`` (read 8.2e-6 after AdamW), as
``tests/test_torch_moe.py`` holds the unsharded step.  Serving: the
logits within 1e-5 of the row's largest magnitude (read up to 1.5e-6
against one process, 3.3e-6 against ``repro``); each primed cache within
``CACHE_RTOL`` = 5e-6 of the leaf's largest (read 9.5e-7: layer 0's
output is summed over ``model`` in another order, so layer 1's K / V or
latent rows move by a few ulps).  Bit for bit: the greedy tokens, the
ranks' ``top_i``, the replicated leaves and Adafactor's state across
ranks, the checkpoint's restored parts and ``verify_step``.

Rank functions are module-level (the children unpickle them by importing
this file), and JAX is imported only inside the tests and fixtures that
use it.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.dist.sharding import use_mesh  # noqa: E402
from repro_torch.launch import mesh as lm  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.optim import TrainState, leaf_path  # noqa: E402

pytestmark = pytest.mark.timeout(600)

STEPS = 2
TRAIN_SEQ, TRAIN_BATCH = 32, 4
PROMPT_LENS = (13, 16, 13, 16)
MAX_SEQ = 32
DECODE_STEPS = 8
VERIFY_T = 4
METRIC_RTOL = 1e-6
REPRO_RTOL = 1e-4
LOGIT_RTOL = 1e-5
CACHE_RTOL = 5e-6
STATE_RTOL = 1e-5
PARAM_ATOL = {"adafactor": 1e-6, "adamw": 5e-5}
METRICS = ("loss", "ce_loss", "grad_norm")
AUX = ("moe_balance", "moe_zloss")

QWEN, LLAMA, MINICPM = "qwen3-moe-235b-a22b", "llama4-scout-17b-a16e", "minicpm3-4b"
MODELS = {  # name -> (arch, overrides; "moe.x" / "mla.x" replace the sub-config's field)
    "qwen3-moe": (QWEN, {}),
    "moe-3-experts-scatter": (QWEN, {"moe.n_experts": 3, "moe.dispatch": "scatter"}),
    "llama4-3-heads": (LLAMA, {"n_heads": 3}),
    "minicpm3": (MINICPM, {}),
    "mla-3-heads": (MINICPM, {"n_heads": 3, "n_kv_heads": 3}),
}
TRAIN_CASES = {  # name -> (model, optimizer)
    "qwen3-moe-adamw": ("qwen3-moe", "adamw"),
    "moe-3-experts-scatter-adafactor": ("moe-3-experts-scatter", "adafactor"),
    "llama4-3-heads-adafactor": ("llama4-3-heads", "adafactor"),
    "minicpm3-adafactor": ("minicpm3", "adafactor"),
    "minicpm3-adamw": ("minicpm3", "adamw"),
    "mla-3-heads-adamw": ("mla-3-heads", "adamw"),
}
SERVE_CASES = tuple(MODELS)
CKPT_CASE = "qwen3-moe-adamw"  # its state after the steps is saved on (1, 2)


def _apply(cfg, overrides: dict):
    flat = {k: v for k, v in overrides.items() if "." not in k}
    cfg = cfg.replace(dtype="float32", **flat)
    for key, v in overrides.items():
        if "." in key:
            head, field = key.split(".")
            cfg = cfg.replace(**{head: dataclasses.replace(getattr(cfg, head), **{field: v})})
    return cfg


def _cfg(model: str, optimizer: str = "adamw"):
    arch, overrides = MODELS[model]
    return _apply(reduced_config(arch), overrides).replace(optimizer=optimizer)


def _jax_cfg(model: str, optimizer: str = "adamw"):
    from repro.configs import reduced_config as jax_reduced_config

    arch, overrides = MODELS[model]
    jcfg = _apply(jax_reduced_config(arch), overrides).replace(optimizer=optimizer)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(_cfg(model, optimizer))
    return jcfg


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()[:16]


class _Routing:
    """Records a digest of every router call's ``top_i`` while active (the
    MoE layers look ``_router`` up in their module at each call)."""

    def __init__(self):
        self.digests: list = []

    def __enter__(self):
        from repro_torch.models import moe as moe_mod

        self.mod, self.real = moe_mod, moe_mod._router

        def router(*args):
            top_p, top_i, aux = self.real(*args)
            self.digests.append(_digest(top_i))
            return top_p, top_i, aux

        moe_mod._router = router
        return self

    def __exit__(self, *exc):
        self.mod._router = self.real


def _state_parts(state) -> dict:
    """A state's local parts as numpy: parameters, optimizer state (by key
    path) and the shards."""
    sh = state.params.shards
    return {"params": {n: p.detach().numpy().copy() for n, p in state.params.named_parameters()},
            "opt": {k: v.detach().numpy().copy() for k, v in _flat(state.opt).items()},
            "shards": {n: None if sh is None else (sh[n].full, sh[n].index)
                       for n, _ in state.params.named_parameters()},
            "step": int(state.step)}


# ---------------------------------------------------------------------------
# What every process runs: training and serving from repro's weights.
# ---------------------------------------------------------------------------

def _train(name: str, pack, ckpt_dir=None) -> dict:
    """``STEPS`` staged steps of the case from ``repro``'s initial state
    (numpy trees) on its batches; the checkpoint case saves its state in
    ``ckpt_dir``."""
    from repro_torch.bridge import train_state_from_numpy
    from repro_torch.runtime.train import build_train_step

    model, opt = TRAIN_CASES[name]
    cfg = _cfg(model, opt)
    p_tree, o_tree, step, batches = pack
    state = train_state_from_numpy(p_tree, o_tree, step, cfg, device="cpu")
    art = build_train_step(cfg)
    metrics = []
    with _Routing() as routing:
        for b in batches:
            state, m = art(state, {k: torch.from_numpy(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    if ckpt_dir is not None:
        CheckpointManager(ckpt_dir).save(int(state.step), state, block=True)
    return {"metrics": metrics, "top_i": routing.digests, **_state_parts(state)}


def _serve(model: str, tree, n: int = len(PROMPT_LENS)) -> dict:
    """The case's serving run on the active mesh (or one process off it)
    from ``repro``'s weights ``tree`` (``tests/test_torch_tp_serve.py``'s
    run) on the first ``n`` prompts: each prompt prefilled and primed, a
    pool of ``n`` slots (this rank's ``rows`` of it where the batch axes
    split it), greedy ``build_serve_step`` steps, the same steps through
    ``decode_step`` for the whole logits, and ``verify_step`` against them
    bit for bit; the last two declare the rows' split, as the serve step
    does."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.dist.sharding import batch_split_axes, rows_split, split_rows
    from repro_torch.models import ShapeSpec, decode_step, gather_logits, init_cache, verify_step
    from repro_torch.runtime.serve import build_prefill_fn, build_serve_step, prime_cache

    cfg = _cfg(model)
    params = params_from_numpy(tree, cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=L).astype(np.int32) for L in PROMPT_LENS[:n]]
    prefill_fn = build_prefill_fn(cfg)
    with split_rows(batch_split_axes(n)):
        split = rows_split()
    per_rank = n if split is None else n // split.size
    first_row = 0 if split is None else split.rank * per_rank
    rows = list(range(first_row, first_row + per_rank))
    primed, first = [], []
    with _Routing() as routing:
        for p in prompts:
            tok, caches = prefill_fn(params, {"tokens": torch.from_numpy(p[None])})
            primed.append(prime_cache(cfg, caches, len(p), MAX_SEQ))
            first.append(tok)

        def pool():
            c = init_cache(cfg, n, MAX_SEQ, device="cpu")
            for i, b in enumerate(rows):
                for k in c:
                    c[k][:, i:i + 1] = primed[b][k]
            return c

        lens = torch.tensor(PROMPT_LENS[:n], dtype=torch.int32)[rows]
        step = build_serve_step(cfg, ShapeSpec("t", "decode", MAX_SEQ, n))
        tok, caches, toks = torch.cat(first)[rows], pool(), []
        toks.append(tok)
        for i in range(DECODE_STEPS):
            tok, caches = step(params, tok, caches, lens + i)
            toks.append(tok)
    caches, local, logits = pool(), [], []
    with split_rows(batch_split_axes(n)):
        for i in range(DECODE_STEPS):
            lg, caches = decode_step(params, toks[i], caches, lens + i, cfg)
            local.append(lg)
            logits.append(gather_logits(params, lg))
        vl, _ = verify_step(params, torch.cat(toks[:VERIFY_T], dim=1), pool(), lens, cfg)
    return {"toks": torch.cat(toks, dim=1).numpy(), "logits": torch.stack(logits)[:, :, 0].numpy(),
            "verify_bitexact": all(torch.equal(vl[:, j], local[j][:, 0]) for j in range(VERIFY_T)),
            "primed": [{k: v.numpy().copy() for k, v in p.items()} for p in primed], "rows": rows,
            "seq_len": getattr(caches, "seq_len", None), "top_i": routing.digests}


def _restore(ckpt_dir: str) -> dict:
    cfg = _cfg(*TRAIN_CASES[CKPT_CASE])
    template = TrainState(step=torch.zeros((), dtype=torch.int32), params=Transformer(cfg, device="meta"), opt=None)
    step, restored = CheckpointManager(ckpt_dir).restore(template)
    return {"step": step, **_state_parts(restored)}


def _rank_cases(packs: dict, trees: dict, save_dir=None, restore_dir=None) -> dict:
    torch.set_num_threads(1)  # the ranks share the host's cores; their tensors are small
    out = {"train": {name: _train(name, packs[name], save_dir if name == CKPT_CASE else None)
                     for name in TRAIN_CASES},
           "serve": {name: _serve(name, trees[name]) for name in SERVE_CASES}}
    if restore_dir is not None:
        out["restored"] = _restore(restore_dir)
    return out


# ---------------------------------------------------------------------------
# repro's side and the process groups.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def repro_train():
    """Per train case: ``repro``'s initial state (numpy trees) and batches,
    and its own ``STEPS`` steps → (pack, metrics, params tree, opt tree)."""
    import jax
    import jax.numpy as jnp

    from repro.data import SyntheticLMDataset as JaxDataset
    from repro.models.config import ShapeSpec as JaxShape
    from repro.runtime.train import build_train_step as jax_build_train_step
    from repro.runtime.train import init_train_state as jax_init_train_state

    out = {}
    for name, (model, opt) in TRAIN_CASES.items():
        jcfg = _jax_cfg(model, opt)
        js = jax_init_train_state(jax.random.PRNGKey(0), jcfg)
        ds = JaxDataset(jcfg, JaxShape("t", "train", TRAIN_SEQ, TRAIN_BATCH), seed=0)
        batches = [ds.batch_for_step(i) for i in range(STEPS)]
        pack = (jax.tree.map(np.asarray, js.params), jax.tree.map(np.asarray, js.opt), int(js.step), batches)
        art = jax_build_train_step(jcfg, donate=False)
        metrics = []
        for b in batches:
            js, jm = art(js, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in jm.items()})
        out[name] = (pack, metrics, jax.tree.map(np.asarray, js.params), jax.tree.map(np.asarray, js.opt))
    return out


@pytest.fixture(scope="module")
def trees():
    """``repro``'s initial weights of each serving case (numpy trees)."""
    import jax

    from repro.models import init_params as jax_init_params

    return {name: jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), _jax_cfg(name)))
            for name in SERVE_CASES}


@pytest.fixture(scope="module")
def packs(repro_train):
    return {name: r[0] for name, r in repro_train.items()}


@pytest.fixture(scope="module")
def one_process(packs, trees):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run: small tensors
    try:
        with use_mesh(None):
            return {"train": {name: _train(name, packs[name]) for name in TRAIN_CASES},
                    "serve": {name: _serve(name, trees[name]) for name in SERVE_CASES}}
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ep_ckpt"))


@pytest.fixture(scope="module")
def two_ranks(packs, trees, ckpt_dir):
    return lm.spawn_mesh(functools.partial(_rank_cases, packs, trees, ckpt_dir), 2, (1, 2), ("data", "model"),
                         timeout=400.0)


@pytest.fixture(scope="module")
def four_ranks(packs, trees, ckpt_dir, two_ranks):
    # after the (1, 2) group: it writes the checkpoint this group restores
    return lm.spawn_mesh(functools.partial(_rank_cases, packs, trees, None, ckpt_dir), 4, (1, 4),
                         ("data", "model"), timeout=400.0)


DP_CASES = ("qwen3-moe-adamw", "moe-3-experts-scatter-adafactor", "llama4-3-heads-adafactor")
DP_SERVE_CASES = ("qwen3-moe", "moe-3-experts-scatter")
# serving batches on (2, 2): 3 prompts, which the data axis does not divide
# (every data rank holds the whole batch), and 4, two rows a data rank
DP_SERVE_BATCHES = (3, len(PROMPT_LENS))


def _dp_rank_cases(packs: dict, trees: dict) -> dict:
    torch.set_num_threads(1)
    return {"train": {name: _train(name, packs[name]) for name in DP_CASES},
            "serve": {(name, n): _serve(name, trees[name], n) for name in DP_SERVE_CASES for n in DP_SERVE_BATCHES}}


@pytest.fixture(scope="module")
def data_x_model(packs, trees):
    """A (2, 2) data × model group: each rank trains on its half of the
    global batch, whose 128 tokens form one dispatch group across both
    data rows, and serves ``DP_SERVE_BATCHES``."""
    return lm.spawn_mesh(functools.partial(_dp_rank_cases, packs, trees), 4, (2, 2), ("data", "model"),
                         timeout=400.0)


@pytest.fixture(scope="module")
def one_process_dp(trees):
    """One process's serving runs of ``DP_SERVE_CASES`` on the batches of
    ``DP_SERVE_BATCHES`` that ``one_process`` does not serve."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with use_mesh(None):
            return {(name, n): _serve(name, trees[name], n) for name in DP_SERVE_CASES
                    for n in DP_SERVE_BATCHES if n != len(PROMPT_LENS)}
    finally:
        torch.set_num_threads(threads)


def _ranks(two_ranks, four_ranks, m: int) -> list:
    return two_ranks if m == 2 else four_ranks


# ---------------------------------------------------------------------------
# The layouts.
# ---------------------------------------------------------------------------

class FakeMesh:
    """A mesh-like object: the axis sizes, no process group."""

    def __init__(self, **sizes):
        self.shape = sizes


@pytest.mark.parametrize("m", [2, 4, 16])
def test_the_layers_shard_as_safe_spec_lays_them_out(m):
    """On a meta build: experts sharded where m divides them, else the
    expert width; MLA's heads where m divides them; the router, MLA's
    latent projections and norms replicated."""
    fake = FakeMesh(data=1, model=m)
    for model in ("qwen3-moe", "moe-3-experts-scatter", "minicpm3", "mla-3-heads"):
        cfg = _cfg(model)
        with use_mesh(fake):
            t = Transformer(cfg, device="meta")
        layer = t.layers[0]
        if cfg.moe is not None:
            E, F = cfg.moe.n_experts, cfg.moe.d_ff_expert
            ep = E % m == 0
            assert layer.moe.ep == ep and (layer.moe.tp is not None) == (ep or F % m == 0)
            assert tuple(layer.moe.wi_gate.shape) == (E // m if ep else E, cfg.d_model,
                                                      F if ep or F % m else F // m)
            assert tuple(layer.moe.router.shape) == (cfg.d_model, E)
        else:
            H = cfg.n_heads
            assert (layer.attn.tp is not None) == (H % m == 0)
            assert layer.attn.wq_b.shape[1] == (H // m if H % m == 0 else H)
            assert tuple(layer.attn.wq_a.shape) == (cfg.d_model, cfg.mla.q_lora_rank)
            assert tuple(layer.attn.wkv_a.shape) == (cfg.d_model, cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim)


PROD_MESHES = {"pod_16x16": dict(data=16, model=16), "multipod_2x16x16": dict(pod=2, data=16, model=16)}


@pytest.mark.parametrize("mesh", sorted(PROD_MESHES))
@pytest.mark.parametrize("arch", [QWEN, LLAMA, MINICPM])
def test_cache_shardings_equal_repro(arch, mesh):
    """``runtime.serve.cache_shardings`` of the MoE configs' KV caches
    (both ``kv_shard`` values) and of MLA's latent cache equals ``repro``'s
    (``safe_spec`` of its ``cache_defs``) on both production meshes."""
    from repro.configs import get_config as jax_get_config
    from repro.dist.sharding import safe_spec as jax_safe_spec
    from repro.models.transformer import cache_defs as jax_cache_defs
    from repro_torch.configs import get_config
    from repro_torch.runtime.serve import cache_shardings

    fake = FakeMesh(**PROD_MESHES[mesh])
    for kv_shard in ("seq", "heads"):
        for batch, seq in ((128, 32_768), (3, 777)):
            jcfg = jax_get_config(arch).replace(kv_shard=kv_shard)
            want = {k: tuple(jax_safe_spec(d.shape, d.axes, mesh=fake))
                    for k, d in jax_cache_defs(jcfg, batch, seq).items()}
            got = {k: tuple(v) for k, v in cache_shardings(get_config(arch).replace(kv_shard=kv_shard), batch, seq,
                                                            fake).items()}
            assert got == want, (kv_shard, batch, seq)


def test_latent_part_follows_the_cache_spec():
    """Rows from the rank's offset where m divides them, else whole."""
    from repro_torch.dist.sharding import DryRunMesh, ModelAxis
    from repro_torch.models import mla

    cfg = _cfg("minicpm3")
    axis = ModelAxis(DryRunMesh({"data": 1, "model": 4}))  # rank 0
    assert mla.latent_part(cfg, 32, axis) == ("seq", 0, 32)
    assert mla.latent_part(cfg, 22, axis) == ("whole", 0, 22)
    assert mla.latent_part(cfg, 32, None) is None


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b", "hubert-xlarge", "internvl2-2b"])
def test_the_other_kinds_still_raise_naming_item_5_6(arch):
    from repro_torch.runtime.train import build_train_step

    cfg = reduced_config(arch)
    with use_mesh(FakeMesh(data=1, model=2)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 5.6"):
            Transformer(cfg, device="meta")
        with pytest.raises(NotImplementedError, match="Queue 1 item 5.6"):
            build_train_step(cfg)


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------

def _opt_parts(rank: dict) -> dict:
    """AdamW's ``m`` / ``v`` of a ``_state_parts`` result as ``gather_params``
    inputs, one per key."""
    return {key: {"params": {key.split("/", 1)[1]: a}, "shards": rank["shards"]} for key, a in rank["opt"].items()}


def _gathered_opt(ranks: list) -> dict:
    parts = [_opt_parts(r) for r in ranks]
    return {key: lm.gather_params([p[key] for p in parts])[key.split("/", 1)[1]] for key in parts[0]}


def _check_metrics(got: list, want: list, keys, rtol: float, what: str) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=f"{what}: {k} at step {i}")


def _keys(name: str) -> tuple:
    return METRICS + (AUX if _cfg(TRAIN_CASES[name][0]).moe is not None else ())


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_steps_match_one_process(two_ranks, four_ranks, one_process, case, m):
    ranks = [r["train"][case] for r in _ranks(two_ranks, four_ranks, m)]
    one = one_process["train"][case]
    opt = TRAIN_CASES[case][1]
    for r in ranks:
        _check_metrics(r["metrics"], one["metrics"], _keys(case), METRIC_RTOL, f"rank of {m}")
        assert r["step"] == STEPS
    full = lm.gather_params(ranks)
    assert set(full) == set(one["params"])
    for n, p in one["params"].items():
        np.testing.assert_allclose(full[n], p, rtol=0, atol=PARAM_ATOL[opt], err_msg=n)
    for n in lm.replicated_names(ranks[0]):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["params"][n], ranks[0]["params"][n], err_msg=n)
    if opt == "adafactor":  # whole on every rank, the same bits
        for k, w in one["opt"].items():
            for r in ranks[1:]:
                np.testing.assert_array_equal(r["opt"][k], ranks[0]["opt"][k], err_msg=k)
            np.testing.assert_allclose(ranks[0]["opt"][k], w, rtol=0, atol=STATE_RTOL * np.abs(w).max(), err_msg=k)
    else:  # m / v: the parameters' parts
        got = _gathered_opt(ranks)
        for key, w in one["opt"].items():
            np.testing.assert_allclose(got[key], w, rtol=0, atol=STATE_RTOL * np.abs(w).max() + 1e-30, err_msg=key)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_steps_match_repro(two_ranks, four_ranks, repro_train, case, m):
    _, want_metrics, want_params, _ = repro_train[case]
    ranks = [r["train"][case] for r in _ranks(two_ranks, four_ranks, m)]
    for r in ranks:
        _check_metrics(r["metrics"], want_metrics, METRICS, REPRO_RTOL, f"rank of {m} against repro")
    full = lm.gather_params(ranks)
    for n, p in full.items():
        path, layer = leaf_path(n)
        w = want_params
        for k in path.split("/"):
            w = w[k]
        np.testing.assert_allclose(p, w if layer is None else w[layer], rtol=0,
                                   atol=PARAM_ATOL[TRAIN_CASES[case][1]], err_msg=n)


@pytest.mark.parametrize("m", [2, 4])
def test_every_rank_routes_alike(two_ranks, four_ranks, m):
    """Every router call (forward, the remat recompute, prefill and decode)
    gave the same ``top_i`` bits on every rank."""
    ranks = _ranks(two_ranks, four_ranks, m)
    for kind, models in (("train", {n: c[0] for n, c in TRAIN_CASES.items()}), ("serve", {n: n for n in SERVE_CASES})):
        for name, model in models.items():
            got = [r[kind][name]["top_i"] for r in ranks]
            assert all(g == got[0] for g in got[1:]), (kind, name)
            assert bool(got[0]) == (_cfg(model).moe is not None), (kind, name)


@pytest.mark.parametrize("case", DP_CASES)
def test_data_parallel_moe_routes_over_the_global_batch(data_x_model, one_process, repro_train, case):
    """On (2, 2) the MoE's dispatch group, its capacity and the
    load-balance loss's means are the global batch's (``repro``'s under
    GSPMD): each data row's step equals one process's (the metrics within
    ``METRIC_RTOL``, the parameters within ``PARAM_ATOL``) and ``repro``'s,
    ``moe_balance`` included, and both data rows route alike."""
    ranks = [r["train"][case] for r in data_x_model]
    one = one_process["train"][case]
    _, want_metrics, _, _ = repro_train[case]
    opt = TRAIN_CASES[case][1]
    for r in ranks:
        _check_metrics(r["metrics"], one["metrics"], _keys(case), METRIC_RTOL, "rank of (2, 2)")
        _check_metrics(r["metrics"], want_metrics, METRICS, REPRO_RTOL, "rank of (2, 2) against repro")
    for rows in (ranks[:2], ranks[2:]):
        full = lm.gather_params(rows)
        for n, p in one["params"].items():
            np.testing.assert_allclose(full[n], p, rtol=0, atol=PARAM_ATOL[opt], err_msg=n)
    assert ranks[0]["top_i"] == ranks[1]["top_i"] and ranks[2]["top_i"] == ranks[3]["top_i"]


@pytest.mark.parametrize("n", DP_SERVE_BATCHES)
@pytest.mark.parametrize("case", DP_SERVE_CASES)
def test_data_parallel_moe_serves_its_rows(data_x_model, one_process, one_process_dp, case, n):
    """On (2, 2) a serving batch of 3, which the data axis does not divide,
    is whole on every data rank and each routes it alone; a batch of 4 is
    split, two rows a data rank, and routed over both (the steps declare
    the split).  Either way each rank's greedy tokens equal one process's
    for its rows, its logits within ``LOGIT_RTOL`` of the row's largest,
    ``verify_step`` bit for bit its decode steps, and the two ranks of a
    data row route alike; with 3 both data rows give the same tokens."""
    one = one_process["serve"][case] if n == len(PROMPT_LENS) else one_process_dp[(case, n)]
    ranks = [r["serve"][(case, n)] for r in data_x_model]
    want_rows = [list(range(n))] * 4 if n % 2 else [[0, 1], [0, 1], [2, 3], [2, 3]]
    for r, got in enumerate(ranks):
        assert got["rows"] == want_rows[r], (r, got["rows"])
        np.testing.assert_array_equal(got["toks"], one["toks"][got["rows"]], err_msg=f"rank {r}")
        _check_logits(got["logits"], one["logits"][:, got["rows"]], f"rank {r} against one process")
        assert got["verify_bitexact"], r
    assert ranks[0]["top_i"] == ranks[1]["top_i"] and ranks[2]["top_i"] == ranks[3]["top_i"]
    if n % 2:
        assert ranks[0]["top_i"] == ranks[2]["top_i"]


def test_a_moe_batch_must_split_over_every_batch_axis():
    """A global batch the data axis cannot divide would leave each rank the
    whole batch, which the global routing would count twice: refused."""
    from repro_torch.dist.sharding import DryRunMesh
    from repro_torch.runtime.train import build_train_step, init_train_state

    cfg = _cfg("qwen3-moe")
    with use_mesh(DryRunMesh({"data": 2, "model": 1})):
        state = init_train_state(cfg, 0, device="cpu")
        art = build_train_step(cfg)
        tokens = torch.zeros((3, 8), dtype=torch.int32)
        with pytest.raises(ValueError, match="global batch"):
            art(state, {"tokens": tokens, "labels": tokens})


def test_expert_parallel_state_bytes_are_a_share():
    """Reduced qwen3-moe on (1, 2): each rank holds 2 of the 4 experts'
    weights; the router stays whole."""
    from repro_torch.dist.sharding import DryRunMesh

    cfg = _cfg("qwen3-moe")
    with use_mesh(DryRunMesh({"data": 1, "model": 2})):
        t = Transformer(cfg, device="meta")
    for name, sh in t.shards.items():
        if ".moe.w" in name:
            assert sh.spec[0] == "model" and dict(t.named_parameters())[name].shape[0] * 2 == sh.full[0], name
        if name.endswith("moe.router"):
            assert not sh.sharded


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def repro_tokens(trees):
    """``repro``'s own greedy run of each serving case on the same weights:
    each prompt through ``prefill`` and ``prime_cache``, the slots
    concatenated, ``DECODE_STEPS`` ``decode_step``s at per-slot positions
    → (tokens (B, DECODE_STEPS + 1), logits (DECODE_STEPS, B, V)).
    ``prefill`` and ``decode_step`` are jitted (as ``repro``'s serving
    steps are): one compilation a shape, not one an operation."""
    import jax
    import jax.numpy as jnp

    from repro.models import decode_step as jax_decode_step
    from repro.models import prefill as jax_prefill
    from repro.runtime.serve import prime_cache as jax_prime_cache

    out = {}
    for name in SERVE_CASES:
        jcfg, params = _jax_cfg(name), trees[name]
        prefill_fn = jax.jit(functools.partial(jax_prefill, cfg=jcfg))
        decode_fn = jax.jit(functools.partial(jax_decode_step, cfg=jcfg))
        rng = np.random.default_rng(0)
        caches, first = [], []
        for L in PROMPT_LENS:
            p = rng.integers(0, jcfg.vocab, size=L).astype(np.int32)
            lg, c = prefill_fn(params, {"tokens": jnp.asarray(p[None])})
            caches.append(jax_prime_cache(jcfg, c, L, MAX_SEQ))
            first.append(np.asarray(jnp.argmax(lg[:, -1], axis=-1), np.int32))
        cache = {k: jnp.concatenate([c[k] for c in caches], axis=1) for k in caches[0]}
        tok = np.stack(first)
        toks, logits = [tok], []
        for i in range(DECODE_STEPS):
            pos = np.asarray([L + i for L in PROMPT_LENS], np.int32)
            lg, cache = decode_fn(params, jnp.asarray(tok), cache, jnp.asarray(pos))
            logits.append(np.asarray(lg[:, 0], np.float32))
            tok = np.asarray(jnp.argmax(lg[:, 0], axis=-1), np.int32)[:, None]
            toks.append(tok)
        out[name] = (np.concatenate(toks, axis=1), np.stack(logits))
    return out


def _check_logits(got: np.ndarray, want: np.ndarray, what: str) -> None:
    scale = np.abs(want).max(axis=-1, keepdims=True)
    worst = float((np.abs(got - want) / scale).max())
    assert worst <= LOGIT_RTOL, f"{what}: {worst:.2e} of the row's largest"


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", SERVE_CASES)
def test_greedy_serve_steps_equal_one_process_and_repro(two_ranks, four_ranks, one_process, repro_tokens, case, m):
    want_toks, want_logits = repro_tokens[case]
    one = one_process["serve"][case]
    np.testing.assert_array_equal(one["toks"], want_toks)
    _check_logits(one["logits"], want_logits, "one process against repro")
    for r, got in enumerate(x["serve"][case] for x in _ranks(two_ranks, four_ranks, m)):
        np.testing.assert_array_equal(got["toks"], one["toks"], err_msg=f"rank {r}")
        _check_logits(got["logits"], one["logits"], f"rank {r} against one process")
        _check_logits(got["logits"], want_logits, f"rank {r} against repro")
        assert got["seq_len"] == MAX_SEQ and got["verify_bitexact"]
    assert one["verify_bitexact"]


def _rank_slice(arr: np.ndarray, name: str, cfg, r: int, m: int) -> np.ndarray:
    """Rank ``r``'s part of one process's primed leaf ``name`` under
    ``cache_shardings`` on (data 1, model m)."""
    from repro_torch.runtime.serve import cache_shardings

    spec = cache_shardings(cfg, 1, MAX_SEQ, FakeMesh(data=1, model=m))[name]
    index = tuple(slice(r * (n // m), (r + 1) * (n // m)) if e == "model" else slice(None)
                  for n, e in zip(arr.shape, spec))
    return arr[index]


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", SERVE_CASES)
def test_each_rank_primes_its_slice(two_ranks, four_ranks, one_process, case, m):
    """Each rank's primed caches (MLA: the latent rows; GQA: the KV rows)
    are its slice of one process's."""
    cfg = _cfg(case)
    for r, got in enumerate(x["serve"][case] for x in _ranks(two_ranks, four_ranks, m)):
        for p, (g, w) in enumerate(zip(got["primed"], one_process["serve"][case]["primed"])):
            assert set(g) == ({"c_kv", "k_rope"} if cfg.mla is not None else {"k", "v"})
            for leaf in g:
                want = _rank_slice(w[leaf], leaf, cfg, r, m)
                assert g[leaf].shape == want.shape, (r, p, leaf)
                np.testing.assert_allclose(g[leaf], want, rtol=0, atol=CACHE_RTOL * np.abs(w[leaf]).max(),
                                           err_msg=f"rank {r}, prompt {p}, {leaf}")


def test_the_positions_cross_the_ranks_rows():
    for m in (2, 4):
        rows = MAX_SEQ // m
        assert any((L - 1) // rows != (L + DECODE_STEPS - 1) // rows for L in PROMPT_LENS), m
    assert any(L % 4 for L in PROMPT_LENS) and any(L % 4 == 0 for L in PROMPT_LENS)


# ---------------------------------------------------------------------------
# The expert-sharded checkpoint.
# ---------------------------------------------------------------------------

def test_expert_sharded_checkpoint_restores_onto_four_ranks(two_ranks, four_ranks, ckpt_dir):
    """Written on (1, 2) (2 experts a rank), restored onto (1, 4) (1
    expert a rank): every part of the parameters and of AdamW's m / v bit
    for bit the state the (1, 2) ranks held; the manifest lists the expert
    leaves' 2 shards."""
    import json
    import os

    saved = [r["train"][CKPT_CASE] for r in two_ranks]
    restored = [r["restored"] for r in four_ranks]
    assert all(r["step"] == STEPS for r in restored)
    want, got = lm.gather_params(saved), lm.gather_params(restored)
    for n, p in want.items():
        np.testing.assert_array_equal(got[n], p, err_msg=n)
    assert restored[1]["params"]["layers.0.moe.wi_gate"].shape[0] == 1
    want_o, got_o = _gathered_opt(saved), _gathered_opt(restored)
    assert set(got_o) == set(want_o)
    for k, w in want_o.items():
        np.testing.assert_array_equal(got_o[k], w, err_msg=k)
    step_dir = os.path.join(ckpt_dir, f"step_{STEPS:09d}")
    with open(os.path.join(step_dir, "MANIFEST.json")) as f:
        leaves = {e["path"]: e for e in json.load(f)["leaves"]}
    for path in (".params/['layers']/['moe']/['wi_gate']", ".opt/['m']/['layers']/['moe']/['wo']"):
        assert leaves[path]["spec"] == [[], ["model"], [], []] and len(leaves[path]["shards"]) == 2, path
    assert "file" in leaves[".params/['layers']/['moe']/['router']"]


def test_expert_sharded_checkpoint_restores_off_the_mesh(two_ranks, ckpt_dir):
    saved = [r["train"][CKPT_CASE] for r in two_ranks]
    with use_mesh(None):
        got = _restore(ckpt_dir)
    assert got["step"] == STEPS and all(v is None for v in got["shards"].values())
    for n, p in lm.gather_params(saved).items():
        np.testing.assert_array_equal(got["params"][n], p, err_msg=n)
    for k, w in _gathered_opt(saved).items():
        np.testing.assert_array_equal(got["opt"][k], w, err_msg=k)
