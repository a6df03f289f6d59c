"""The SSD block, the RG-LRU hybrid and the audio / vision frontends on the
``model`` mesh axis — in training and in serving, against one process of
the port and against ``repro``.

* one module-scoped 2-rank (1, 2) and one 4-rank (1, 4) gloo group, each
  running every ``TRAIN_CASES`` and ``SERVE_CASES`` case from ``repro``'s
  weights (bridged: its whole leaves cut to each rank's parts), float32:
  reduced mamba2-130m (2 layers, 16 heads of 8, one B/C group: ``in_proj``'s
  304 columns split at 152 / 76, inside xh, ``conv``'s 160 channels at 80
  / 40, each rank running its 8 / 4 heads), reduced recurrentgemma-9b (all
  5 layers: one (rec, rec, attn) super-block and two rec tail layers; the
  RG-LRU width 64 over ``model``, windowed MQA with its one KV head
  replicated), reduced hubert-xlarge (the audio frontend, non-causal
  attention, the vocab-parallel head and its masked loss) and reduced
  internvl2-2b (the vision frontend, GQA 2 : 1);
* training (configs from ``launch.mesh.tp_config``'s ``ssm`` / ``hybrid``
  / ``audio`` / ``vision`` variants): 3 staged steps on ``repro``'s data
  stream with AdamW and with Adafactor; each rank's loss, ``ce_loss`` and
  grad norm at every step, every parameter's parts put together after
  the last, and Adafactor's whole state, against one process of the port
  from the same state and against ``repro``'s ``build_train_step``;
  AdamW's ``m`` / ``v`` parts and the parameters after each step k taken
  from ``repro``'s state before it (below); replicated parameters (the
  SSM's ``A_log`` / ``D`` / ``dt_bias``, the norms, the frontends'
  projections) and Adafactor's state the same bits on every rank;
* serving: four prompts (21 / 16 / 13 / 24 tokens; internvl's after its 4
  patches) prefilled one by one and primed into 40-row caches (for
  recurrentgemma a ring of its 16-slot window: the prompts of 21 and 24
  and every decode step wrap it, on 8 / 4 slots a rank), then 8 greedy
  ``build_serve_step`` steps at per-slot positions; the tokens equal one
  process's and ``repro``'s, the logits within ``LOGIT_RTOL`` of their
  row's largest, each rank's primed caches its slice of one process's
  under ``cache_shardings``, the SSM ``state`` (replicated) the same bits
  on every rank after the steps; hubert's encode (the forward and the head
  over every frame) equal to one process's and ``repro``'s;
* a sharded checkpoint of the hybrid (parameters and AdamW's ``m`` / ``v``)
  written on (1, 2) restored onto (1, 4) and off the mesh, bit for bit;
* the layouts: every parameter's and cache leaf's spec equal to
  ``repro``'s ``safe_spec`` of its defs on (1, 2), (1, 4) and (16, 16),
  and each rank's local shapes on a meta build equal to those specs' parts.

Tolerances (float32; the readings are this file's runs on the CPU, over
m = 2 and 4), as ``tests/test_torch_tp_moe_mla.py``'s for the same
quantities or tighter.  Against one process: the metrics within
``METRIC_RTOL`` = 1e-6 relative (read up to 4.7e-7: the ranks' narrower
products and their sums over ``model`` add in another order); parameters
within ``PARAM_ATOL``: 1e-6 after Adafactor (read 2.4e-7) and 5e-5 after
AdamW (read 2.2e-5), whose m / (sqrt(v) + eps) turns float noise in a
near-zero gradient into a share of the step; the optimizer state within
``STATE_RTOL`` = 1e-5 of its leaf's largest magnitude (Adafactor's after
3 steps read 1.6e-6).  AdamW's first update is about lr · sign(g), so the
parameters it leaves differ by a share of lr where a gradient is near
zero, and the next steps' gradients at them differ more: after 3 steps
of one run, m / v read up to 1.56e-5 of the leaf's largest (mamba2's
``in_proj`` m at m = 2; hubert's ``wi`` v 1.03e-5), the parameters'
difference, not a step's error, carried on.  So AdamW's m / v are held
after each step k from one common state, ``repro``'s before step k (the
run's own first step for k = 0), in the ranks and in one process: read
up to 1.56e-6, parameters 2.2e-5 (1.2e-7 for k > 0), on every model,
hubert's vocab-parallel ``head`` among them.  Against ``repro``: the
metrics within ``REPRO_RTOL`` = 1e-4 relative (read 7.3e-7), parameters
within ``PARAM_ATOL``.
Serving: the logits within ``LOGIT_RTOL`` = 1e-5 of the row's largest
(read up to 4.1e-7 against one process); each primed cache within
``CACHE_RTOL`` = 5e-6 of the leaf's largest.  Bit for bit: the greedy
tokens, the replicated leaves and Adafactor's state across ranks, the SSM
state across ranks and the checkpoint's restored parts.

Rank functions are module-level (the children unpickle them by importing
this file), and JAX is imported only inside the tests and fixtures that
use it.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.dist.sharding import DryRunMesh, use_mesh  # noqa: E402
from repro_torch.launch import mesh as lm  # noqa: E402
from repro_torch.models import Transformer, leaf_layout  # noqa: E402
from repro_torch.optim import TrainState, leaf_path  # noqa: E402

pytestmark = pytest.mark.timeout(900)

STEPS = 3  # staged steps a case
TRAIN_SEQ, TRAIN_BATCH = 32, 4
PROMPT_LENS = (21, 16, 13, 24)
MAX_SEQ = 40
DECODE_STEPS = 8
ENCODE_SHAPE = (2, 32)
METRIC_RTOL = 1e-6
REPRO_RTOL = 1e-4
LOGIT_RTOL = 1e-5
CACHE_RTOL = 5e-6
STATE_RTOL = 1e-5
PARAM_ATOL = {"adafactor": 1e-6, "adamw": 5e-5}
METRICS = ("loss", "ce_loss", "grad_norm")

MODELS = {"mamba2": "mamba2-130m", "rgemma": "recurrentgemma-9b", "hubert": "hubert-xlarge",
          "internvl": "internvl2-2b"}
VARIANTS = {"mamba2": "ssm", "rgemma": "hybrid", "hubert": "audio", "internvl": "vision"}  # lm.tp_config's
TRAIN_CASES = {  # name -> (model, optimizer)
    "mamba2-adamw": ("mamba2", "adamw"),
    "mamba2-adafactor": ("mamba2", "adafactor"),
    "rgemma-adamw": ("rgemma", "adamw"),
    "rgemma-adafactor": ("rgemma", "adafactor"),
    "hubert-adamw": ("hubert", "adamw"),
    "hubert-adafactor": ("hubert", "adafactor"),
    "internvl-adamw": ("internvl", "adamw"),
    "internvl-adafactor": ("internvl", "adafactor"),
}
SERVE_CASES = ("mamba2", "rgemma", "internvl")  # hubert is an encoder: its serving call is the encode
CKPT_CASE = "rgemma-adamw"  # its state after the steps is saved on (1, 2)


def _cfg(model: str, optimizer: str = "adamw"):
    cfg = lm.tp_config(VARIANTS[model], optimizer)
    assert cfg == reduced_config(MODELS[model]).replace(dtype="float32", optimizer=optimizer)
    return cfg


def _jax_cfg(model: str, optimizer: str = "adamw"):
    from repro.configs import reduced_config as jax_reduced_config

    jcfg = jax_reduced_config(MODELS[model]).replace(dtype="float32", optimizer=optimizer)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(_cfg(model, optimizer))
    return jcfg


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, list):  # a hybrid's tail caches in repro (a spec is a tuple: a leaf)
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


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
    """The case's ``STEPS`` steps from ``repro``'s initial state (the
    parts after the last, each step's metrics); with AdamW also
    ``stepwise``: the parts after each step k taken from ``repro``'s state
    before it (after the run's own first step for k = 0)."""
    from repro_torch.bridge import train_state_from_numpy
    from repro_torch.runtime.train import build_train_step

    cfg = _cfg(*TRAIN_CASES[name])
    starts, batches = pack
    state = train_state_from_numpy(*starts[0], cfg, device="cpu")
    art = build_train_step(cfg)
    step = lambda st, b: art(st, {k: torch.from_numpy(v) for k, v in b.items()})  # noqa: E731
    metrics, stepwise = [], []
    for b in batches:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
        if cfg.optimizer == "adamw" and not stepwise:
            stepwise.append(_state_parts(state))
    if stepwise:
        for start, b in zip(starts[1:], batches[1:]):
            stepwise.append(_state_parts(step(train_state_from_numpy(*start, cfg, device="cpu"), b)[0]))
    if ckpt_dir is not None:
        CheckpointManager(ckpt_dir).save(int(state.step), state, block=True)
    return {"metrics": metrics, "stepwise": stepwise, **_state_parts(state)}


def _prompt(cfg, rng, L: int) -> dict:
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, L)).astype(np.int32))}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal((1, cfg.n_patches, 1024)).astype(np.float32))
    return batch


def _serve(model: str, tree) -> dict:
    """The case's serving run on the active mesh (or one process off it)
    from ``repro``'s weights ``tree``: each prompt prefilled and primed into
    a slot of ``MAX_SEQ`` rows, greedy ``build_serve_step`` steps, then the
    same steps through ``decode_step`` for the whole logits."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models import ShapeSpec, decode_step, gather_logits, init_cache
    from repro_torch.runtime.serve import build_prefill_fn, build_serve_step, prime_cache

    cfg = _cfg(model)
    params = params_from_numpy(tree, cfg, device="cpu")
    rng = np.random.default_rng(0)
    start = cfg.n_patches if cfg.frontend == "vision" else 0
    prefill_fn = build_prefill_fn(cfg)
    primed, first = [], []
    for L in PROMPT_LENS:
        tok, caches = prefill_fn(params, _prompt(cfg, rng, L))
        primed.append(prime_cache(cfg, caches, start + L, MAX_SEQ))
        first.append(tok)

    def pool():
        c = init_cache(cfg, len(PROMPT_LENS), MAX_SEQ, device="cpu")
        for i, p in enumerate(primed):
            for k in c:
                c[k][:, i:i + 1] = p[k]
        return c

    pos = torch.tensor(PROMPT_LENS, dtype=torch.int32) + start
    step = build_serve_step(cfg, ShapeSpec("t", "decode", MAX_SEQ, len(PROMPT_LENS)))
    tok, caches, toks = torch.cat(first), pool(), []
    toks.append(tok)
    for i in range(DECODE_STEPS):
        tok, caches = step(params, tok, caches, pos + i)
        toks.append(tok)
    state = caches["state"].numpy().copy() if "state" in caches else None
    caches, logits = pool(), []
    for i in range(DECODE_STEPS):
        lg, caches = decode_step(params, toks[i], caches, pos + i, cfg)
        logits.append(gather_logits(params, lg))
    return {"toks": torch.cat(toks, dim=1).numpy(), "logits": torch.stack(logits)[:, :, 0].numpy(),
            "primed": [{k: v.numpy().copy() for k, v in p.items()} for p in primed], "state": state,
            "seq_len": getattr(caches, "seq_len", None)}


def _audio_batch() -> dict:
    """Seeded frame embeddings of ``ENCODE_SHAPE`` and a mask of every 4th
    frame."""
    rng = np.random.default_rng(3)
    B, L = ENCODE_SHAPE
    mask = np.zeros((B, L), dtype=bool)
    mask[:, ::4] = True
    return {"embeds": rng.standard_normal((B, L, 512)).astype(np.float32), "mask": mask}


def _encode(tree) -> np.ndarray:
    """hubert's serving call: the encoder forward and the head over every
    frame, the logits put together over ``model``."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models import forward, gather_logits, head_logits

    cfg = _cfg("hubert")
    params = params_from_numpy(tree, cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _audio_batch().items()}
    with torch.no_grad():
        x, _, _ = forward(params, batch, cfg)
        return gather_logits(params, head_logits(params, x, cfg)).numpy()


def _restore(ckpt_dir: str) -> dict:
    cfg = _cfg(*TRAIN_CASES[CKPT_CASE])
    template = TrainState(step=torch.zeros((), dtype=torch.int32), params=Transformer(cfg, device="meta"), opt=None)
    step, restored = CheckpointManager(ckpt_dir).restore(template)
    return {"step": step, **_state_parts(restored)}


def _rank_cases(packs: dict, trees: dict, save_dir=None, restore_dir=None) -> dict:
    torch.set_num_threads(1)  # the ranks share the host's cores; their tensors are small
    out = {"train": {name: _train(name, packs[name], save_dir if name == CKPT_CASE else None)
                     for name in TRAIN_CASES},
           "serve": {name: _serve(name, trees[name]) for name in SERVE_CASES},
           "encode": _encode(trees["hubert"])}
    if restore_dir is not None:
        out["restored"] = _restore(restore_dir)
    return out


# ---------------------------------------------------------------------------
# repro's side and the process groups.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def repro_train():
    """Per train case: ``repro``'s state before each of its ``STEPS``
    steps ((params, opt, step) as numpy trees) and the batches, and its own
    steps' metrics and final parameters → (pack, metrics, params tree)."""
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
        art = jax_build_train_step(jcfg, donate=False)
        starts, metrics = [], []
        for b in batches:
            starts.append((jax.tree.map(np.asarray, js.params), jax.tree.map(np.asarray, js.opt), int(js.step)))
            js, jm = art(js, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in jm.items()})
        out[name] = ((starts, batches), metrics, jax.tree.map(np.asarray, js.params))
    return out


@pytest.fixture(scope="module")
def trees():
    """``repro``'s initial weights of each model (numpy trees)."""
    import jax

    from repro.models import init_params as jax_init_params

    return {name: jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), _jax_cfg(name)))
            for name in MODELS}


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
                    "serve": {name: _serve(name, trees[name]) for name in SERVE_CASES},
                    "encode": _encode(trees["hubert"])}
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tp_ssm_rec_ckpt"))


@pytest.fixture(scope="module")
def two_ranks(packs, trees, ckpt_dir):
    return lm.spawn_mesh(functools.partial(_rank_cases, packs, trees, ckpt_dir), 2, (1, 2), ("data", "model"),
                         timeout=600.0)


@pytest.fixture(scope="module")
def four_ranks(packs, trees, ckpt_dir, two_ranks):
    # after the (1, 2) group: it writes the checkpoint this group restores
    return lm.spawn_mesh(functools.partial(_rank_cases, packs, trees, None, ckpt_dir), 4, (1, 4),
                         ("data", "model"), timeout=600.0)


def _ranks(two_ranks, four_ranks, m: int) -> list:
    return two_ranks if m == 2 else four_ranks


# ---------------------------------------------------------------------------
# The layouts.
# ---------------------------------------------------------------------------

class FakeMesh:
    """A mesh-like object: the axis sizes, no process group."""

    def __init__(self, **sizes):
        self.shape = sizes


LAYOUT_MESHES = {"1x2": dict(data=1, model=2), "1x4": dict(data=1, model=4), "16x16": dict(data=16, model=16)}


def _jax_specs(defs, fake) -> dict:
    from repro.dist.sharding import safe_spec as jax_safe_spec

    return {k: tuple(jax_safe_spec(d.shape, d.axes, mesh=fake)) for k, d in _flat(defs).items()}


@pytest.mark.parametrize("mesh", sorted(LAYOUT_MESHES))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_param_shardings_equal_repro(model, mesh):
    """``param_shardings`` equals ``repro``'s ``safe_spec`` of its
    ``model_defs`` leaf by leaf, and a meta build on a ``DryRunMesh`` holds
    each parameter at its part under that spec."""
    from repro.models.transformer import model_defs as jax_model_defs
    from repro_torch.models import param_shardings
    from repro_torch.models.param import local_shape

    fake = FakeMesh(**LAYOUT_MESHES[mesh])
    for full in (False, True):
        cfg, jcfg = _cfg(model), _jax_cfg(model)
        if full:
            from repro.configs import get_config as jax_get_config
            from repro_torch.configs import get_config

            cfg, jcfg = get_config(MODELS[model]), jax_get_config(MODELS[model])
        want = _jax_specs(jax_model_defs(jcfg), fake)
        got = {k: tuple(v) for k, v in _flat(param_shardings(cfg, fake)).items()}
        assert got == want, (full, [k for k in want if got.get(k) != want[k]])
    dry = DryRunMesh(LAYOUT_MESHES[mesh])
    with use_mesh(dry):
        t = Transformer(cfg, device="meta")
    params = dict(t.named_parameters())
    for name, sh in t.shards.items():
        assert tuple(params[name].shape) == local_shape(sh.full, sh.spec, dry), name
    assert any(sh.sharded for sh in t.shards.values())


def _port_cache_specs(cfg, batch, seq, fake) -> dict:
    """The port's ``cache_shardings`` per ``repro`` cache leaf: the port's
    caches are flat and stacked over the layers of each kind, ``repro``'s a
    stack of one kind or, for a hybrid, the super-blocks' (``scan``) and
    the remainder's (``tail``) leaves; each ``repro`` leaf's spec is the
    port's leaf's without the layer dim (with it, for a stacked one)."""
    from repro_torch.models import layer_kinds
    from repro_torch.runtime.serve import cache_shardings

    specs = {k: tuple(v) for k, v in cache_shardings(cfg, batch, seq, fake).items()}
    if cfg.family != "hybrid":
        return specs
    out, pat = {}, cfg.hybrid.pattern
    n_super = cfg.n_layers // len(pat)
    for i, kind in enumerate(pat):
        for leaf in ("h", "conv") if kind == "rec" else ("k", "v"):
            out[f"scan/{kind}_{i}/{leaf}"] = specs[leaf]
    for j, kind in enumerate(layer_kinds(cfg)[n_super * len(pat):]):
        for leaf in ("h", "conv") if kind == "rec" else ("k", "v"):
            out[f"tail/{j}/{leaf}"] = specs[leaf][1:]
    return out


@pytest.mark.parametrize("mesh", sorted(LAYOUT_MESHES))
@pytest.mark.parametrize("model", SERVE_CASES)
def test_cache_shardings_equal_repro(model, mesh):
    """``cache_shardings`` equals ``repro``'s ``safe_spec`` of its
    ``cache_defs`` (the SSM ``state`` replicated, its ``conv`` and the RG-LRU
    ``h`` / ``conv`` by channels, the hybrid's ring by slots), reduced and
    at full width (decode_32k and a batch and rows no mesh divides)."""
    from repro.configs import get_config as jax_get_config
    from repro.models.transformer import cache_defs as jax_cache_defs
    from repro_torch.configs import get_config

    fake = FakeMesh(**LAYOUT_MESHES[mesh])
    for cfg, jcfg in ((_cfg(model), _jax_cfg(model)), (get_config(MODELS[model]), jax_get_config(MODELS[model]))):
        for batch, seq in ((128, 32_768), (3, 777), (len(PROMPT_LENS), MAX_SEQ)):
            want = _jax_specs(jax_cache_defs(jcfg, batch, seq), fake)
            assert _port_cache_specs(cfg, batch, seq, fake) == want, (cfg.name, batch, seq)
    if model == "mamba2":  # the state replicated over model, its conv window by channels
        specs = _port_cache_specs(_cfg(model), 4, MAX_SEQ, fake)
        assert specs["state"][2:] == (None, None, None) and specs["conv"][-1] == "model"


def test_the_ssd_plan_follows_the_stored_split():
    """The channels, heads and sub-heads each rank runs: reduced mamba2's
    16 heads of 8 at m = 2 / 4 / 16 are whole heads of its own; full
    mamba2's 24 heads of 64 at m = 16 are 96 channels a rank, sub-heads of
    32, and together the ranks cover every channel once."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    for cfg, m, want in ((_cfg("mamba2"), 2, (64, 8, 8)), (_cfg("mamba2"), 4, (32, 4, 8)),
                         (_cfg("mamba2"), 16, (8, 1, 8)), (get_config("mamba2-130m"), 16, (96, 2, 32)),
                         (get_config("mamba2-130m"), 2, (768, 12, 64))):
        seen = []
        for r in range(m):
            mesh = DryRunMesh({"data": 1, "model": m})
            mesh.get_local_rank = lambda axis, r=r: r
            with use_mesh(mesh):
                layer = ssm.SSM(cfg, dtype=torch.float32, device="meta")
            pl = ssm._plan(layer, cfg)
            assert (pl.c, pl.h1 - pl.h0, pl.Pp) == want, (cfg.name, m, r, pl)
            assert pl.ch0 == r * pl.c and pl.groups == slice(0, 1)
            seen.append((pl.ch0, pl.c))
        assert sorted(seen) == [(r * want[0], want[0]) for r in range(m)]


# ---------------------------------------------------------------------------
# The SSD where m does not divide its channels.
# ---------------------------------------------------------------------------

# reduced mamba2 with 17 state dims on a model axis of 3: d_in 128 is whole on
# every rank, in_proj's 306 columns and the conv's 162 channels are split
def _odd_ssm_cfg():
    cfg = _cfg("mamba2", "adafactor")
    return cfg.replace(ssm=dataclasses.replace(cfg.ssm, d_state=17))


def _odd_ssm_steps() -> dict:
    """2 Adafactor steps of :func:`_odd_ssm_cfg` from the weights seeded with
    0 on one seeded batch (``launch.mesh.tp_train``), on the active mesh."""
    torch.set_num_threads(1)
    out = lm.tp_train("cpu", _odd_ssm_cfg(), steps=2, batch=2, seq=16)
    ssm = {n: sh for n, sh in out["shards"].items() if ".ssm." in n and sh is not None}
    out["split"] = sorted({n.rsplit(".", 1)[1] for n, sh in ssm.items() if tuple(sh[0]) != out["params"][n].shape})
    return out


@pytest.fixture(scope="module")
def three_ranks():
    return lm.spawn_mesh(_odd_ssm_steps, 3, (1, 3), ("data", "model"), timeout=300.0)


def test_the_ssd_runs_whole_where_m_does_not_divide_its_channels(three_ranks):
    """On a model axis of 3 the gated norm and ``out_proj`` stay whole, so
    every rank runs the whole block from ``in_proj`` / ``conv_w`` /
    ``conv_b`` gathered whole, their gradients each rank's slice of its own
    (``gather_from_model(partial=False)``): the losses, grad norms and
    parameters equal one process's within this file's tolerances."""
    with use_mesh(None):
        one = _odd_ssm_steps()
    for r in three_ranks:
        assert r["split"] == ["conv_b", "conv_w", "in_proj"]
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=METRIC_RTOL)
        np.testing.assert_allclose(r["grad_norms"], one["grad_norms"], rtol=METRIC_RTOL)
    full = lm.gather_params(three_ranks)
    for n, p in one["params"].items():
        np.testing.assert_allclose(full[n], p, rtol=0, atol=PARAM_ATOL["adafactor"], err_msg=n)


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------

def _opt_parts(rank: dict) -> dict:
    return {key: {"params": {key.split("/", 1)[1]: a}, "shards": rank["shards"]} for key, a in rank["opt"].items()}


def _gathered_opt(ranks: list) -> dict:
    parts = [_opt_parts(r) for r in ranks]
    return {key: lm.gather_params([p[key] for p in parts])[key.split("/", 1)[1]] for key in parts[0]}


def _check_metrics(got: list, want: list, rtol: float, what: str) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in METRICS:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=f"{what}: {k} at step {i}")


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_steps_match_one_process(two_ranks, four_ranks, one_process, case, m):
    ranks = [r["train"][case] for r in _ranks(two_ranks, four_ranks, m)]
    one = one_process["train"][case]
    opt = TRAIN_CASES[case][1]
    for r in ranks:
        _check_metrics(r["metrics"], one["metrics"], METRIC_RTOL, f"rank of {m}")
        assert r["step"] == len(r["metrics"]) == STEPS
    full = lm.gather_params(ranks)
    assert set(full) == set(one["params"])
    assert any(sh is not None and tuple(sh[0]) != ranks[0]["params"][n].shape for n, sh in ranks[0]["shards"].items())
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
    else:  # m / v (the parameters' parts) after each step from the same state
        assert len(one["stepwise"]) == STEPS
        for k, want in enumerate(one["stepwise"]):
            parts = [r["stepwise"][k] for r in ranks]
            assert all(p["step"] == k + 1 for p in parts)
            got = _gathered_opt(parts)
            assert set(got) == set(want["opt"])
            for key, w in want["opt"].items():
                np.testing.assert_allclose(got[key], w, rtol=0, atol=STATE_RTOL * np.abs(w).max() + 1e-30,
                                           err_msg=f"{key} after step {k}")
            for n, p in lm.gather_params(parts).items():
                np.testing.assert_allclose(p, want["params"][n], rtol=0, atol=PARAM_ATOL[opt],
                                           err_msg=f"{n} after step {k}")


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_steps_match_repro(two_ranks, four_ranks, repro_train, case, m):
    _, want_metrics, want_params = repro_train[case]
    ranks = [r["train"][case] for r in _ranks(two_ranks, four_ranks, m)]
    for r in ranks:
        _check_metrics(r["metrics"], want_metrics, REPRO_RTOL, f"rank of {m} against repro")
    full = lm.gather_params(ranks)
    layout = leaf_layout(_cfg(TRAIN_CASES[case][0]))
    for n, p in full.items():
        path, layer = leaf_path(n, layout)
        w = want_params
        for k in path.split("/"):
            w = w[k]
        np.testing.assert_allclose(p, w if layer is None else w[layer], rtol=0,
                                   atol=PARAM_ATOL[TRAIN_CASES[case][1]], err_msg=n)


def test_the_ssm_replicated_gradients_are_summed():
    """The SSM's ``A_log`` / ``D`` / ``dt_bias`` (replicated, used on each
    rank's channels) are among the gradients the step sums over ``model``,
    and ``in_proj`` where m does not divide its columns (full mamba2 at m =
    16); nothing of the RG-LRU, whose leaves all split together."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import partial_grad_names

    with use_mesh(DryRunMesh({"data": 1, "model": 2})):
        names = partial_grad_names(Transformer(_cfg("mamba2"), device="meta"))
        assert names == tuple(f"layers.{i}.ssm.{n}" for i in range(2) for n in ("A_log", "D", "dt_bias"))
        rg = partial_grad_names(Transformer(_cfg("rgemma"), device="meta"))
        assert rg == ("layers.2.attn.wk", "layers.2.attn.wv")
    with use_mesh(DryRunMesh({"data": 16, "model": 16})):
        full = partial_grad_names(Transformer(get_config("mamba2-130m").replace(n_layers=1), device="meta"))
        assert full == tuple(f"layers.0.ssm.{n}" for n in ("A_log", "D", "dt_bias", "in_proj"))


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def repro_serving(trees):
    """``repro``'s own greedy run of each serving case on the same weights,
    one prompt at a time (its decode takes one position): ``prefill``,
    ``prime_cache``, ``DECODE_STEPS`` ``decode_step``s → (tokens (B,
    DECODE_STEPS + 1), logits (DECODE_STEPS, B, V)); and hubert's encode.
    ``prefill`` and ``decode_step`` are jitted, as ``repro``'s serving
    steps are."""
    import jax
    import jax.numpy as jnp

    from repro.models import decode_step as jax_decode_step
    from repro.models import forward as jax_forward
    from repro.models import prefill as jax_prefill
    from repro.runtime.serve import prime_cache as jax_prime_cache

    out = {}
    for name in SERVE_CASES:
        jcfg, params = _jax_cfg(name), trees[name]
        prefill_fn = jax.jit(functools.partial(jax_prefill, cfg=jcfg))
        decode_fn = jax.jit(functools.partial(jax_decode_step, cfg=jcfg))
        rng = np.random.default_rng(0)
        start = jcfg.n_patches if jcfg.frontend == "vision" else 0
        toks, logits = [], []
        for L in PROMPT_LENS:
            b = {k: jnp.asarray(v.numpy()) for k, v in _prompt(_cfg(name), rng, L).items()}
            lg, c = prefill_fn(params, b)
            cache = jax_prime_cache(jcfg, c, start + L, MAX_SEQ)
            tok = np.asarray(jnp.argmax(lg[:, -1], axis=-1), np.int32)[:, None]
            seq, lgs = [tok], []
            for i in range(DECODE_STEPS):
                lg, cache = decode_fn(params, jnp.asarray(tok), cache, jnp.int32(start + L + i))
                lgs.append(np.asarray(lg[0, 0], np.float32))
                tok = np.asarray(jnp.argmax(lg[:, 0], axis=-1), np.int32)[:, None]
                seq.append(tok)
            toks.append(np.concatenate(seq, axis=1)[0])
            logits.append(np.stack(lgs))
        out[name] = (np.stack(toks), np.stack(logits, axis=1))
    jcfg = _jax_cfg("hubert")
    batch = {k: jnp.asarray(v) for k, v in _audio_batch().items()}
    x, _, _ = jax_forward(trees["hubert"], batch, jcfg)
    out["encode"] = np.asarray(jnp.einsum("bld,dv->blv", x, trees["hubert"]["head"]), np.float32)
    return out


def _check_logits(got: np.ndarray, want: np.ndarray, what: str, vocab: int) -> None:
    got, want = got[..., :vocab], want[..., :vocab]  # a vision model's padding classes hold -1e30
    scale = np.abs(want).max(axis=-1, keepdims=True)
    worst = float((np.abs(got - want) / scale).max())
    assert worst <= LOGIT_RTOL, f"{what}: {worst:.2e} of the row's largest"


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", SERVE_CASES)
def test_greedy_serve_steps_equal_one_process_and_repro(two_ranks, four_ranks, one_process, repro_serving, case, m):
    want_toks, want_logits = repro_serving[case]
    one = one_process["serve"][case]
    V = _cfg(case).vocab
    np.testing.assert_array_equal(one["toks"], want_toks)
    _check_logits(one["logits"], want_logits, "one process against repro", V)
    for r, got in enumerate(x["serve"][case] for x in _ranks(two_ranks, four_ranks, m)):
        np.testing.assert_array_equal(got["toks"], one["toks"], err_msg=f"rank {r}")
        _check_logits(got["logits"], one["logits"], f"rank {r} against one process", V)
        _check_logits(got["logits"], want_logits, f"rank {r} against repro", V)


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
    """Each rank's primed caches are its slice of one process's under
    ``cache_shardings``: the SSM ``state`` whole, its ``conv`` by channels;
    the RG-LRU ``h`` / ``conv`` by channels and the hybrid's ring by
    slots (the prompts of 21 and 24 tokens wrapped it); internvl's KV rows."""
    cfg = _cfg(case)
    want_leaves = {"mamba2": {"state", "conv"}, "rgemma": {"h", "conv", "k", "v"}, "internvl": {"k", "v"}}[case]
    for r, got in enumerate(x["serve"][case] for x in _ranks(two_ranks, four_ranks, m)):
        assert got["seq_len"] == (cfg.hybrid.window if case == "rgemma" else MAX_SEQ)
        for p, (g, w) in enumerate(zip(got["primed"], one_process["serve"][case]["primed"])):
            assert set(g) == want_leaves
            for leaf in g:
                want = _rank_slice(w[leaf], leaf, cfg, r, m)
                assert g[leaf].shape == want.shape, (r, p, leaf)
                assert leaf == "state" or g[leaf].shape != w[leaf].shape, (r, p, leaf)
                np.testing.assert_allclose(g[leaf], want, rtol=0, atol=CACHE_RTOL * np.abs(w[leaf]).max(),
                                           err_msg=f"rank {r}, prompt {p}, {leaf}")


@pytest.mark.parametrize("m", [2, 4])
def test_the_ssm_state_is_the_same_bits_on_every_rank(two_ranks, four_ranks, one_process, m):
    """The SSM ``state`` (replicated) after the serve steps: the same bits
    on every rank, within ``CACHE_RTOL`` of one process's."""
    ranks = [x["serve"]["mamba2"]["state"] for x in _ranks(two_ranks, four_ranks, m)]
    want = one_process["serve"]["mamba2"]["state"]
    for s in ranks[1:]:
        np.testing.assert_array_equal(s, ranks[0])
    np.testing.assert_allclose(ranks[0], want, rtol=0, atol=CACHE_RTOL * np.abs(want).max())


def test_the_prompts_wrap_the_ring_and_cross_the_ranks_slots():
    window = _cfg("rgemma").hybrid.window
    assert sum(L > window for L in PROMPT_LENS) >= 2
    for m in (2, 4):
        part = window // m
        assert any(len({(L + i) % window // part for i in range(DECODE_STEPS)}) > 1 for L in PROMPT_LENS), m


@pytest.mark.parametrize("m", [2, 4])
def test_hubert_encode_equals_one_process_and_repro(two_ranks, four_ranks, one_process, repro_serving, m):
    """The encoder forward and the vocab-parallel head over every frame
    (every 4th frame masked), put together over ``model``."""
    cfg = _cfg("hubert")
    want = one_process["encode"]
    assert want.shape == ENCODE_SHAPE + (cfg.padded_vocab,)
    _check_logits(want, repro_serving["encode"], "one process against repro", cfg.padded_vocab)
    for r, x in enumerate(_ranks(two_ranks, four_ranks, m)):
        _check_logits(x["encode"], want, f"rank {r} against one process", cfg.padded_vocab)


# ---------------------------------------------------------------------------
# The sharded checkpoint.
# ---------------------------------------------------------------------------

def test_sharded_checkpoint_restores_onto_four_ranks(two_ranks, four_ranks, ckpt_dir):
    """Written on (1, 2), restored onto (1, 4): every part of the hybrid's
    parameters (the super-block's stacked leaves and the tail's) and of
    AdamW's m / v bit for bit the state the (1, 2) ranks held."""
    saved = [r["train"][CKPT_CASE] for r in two_ranks]
    restored = [r["restored"] for r in four_ranks]
    assert all(r["step"] == STEPS for r in restored)
    want, got = lm.gather_params(saved), lm.gather_params(restored)
    for n, p in want.items():
        np.testing.assert_array_equal(got[n], p, err_msg=n)
    assert restored[1]["params"]["layers.0.rec.w_a"].shape == (64, 16)
    assert restored[1]["params"]["layers.4.rec.out_proj"].shape == (16, 64)
    want_o, got_o = _gathered_opt(saved), _gathered_opt(restored)
    assert set(got_o) == set(want_o)
    for k, w in want_o.items():
        np.testing.assert_array_equal(got_o[k], w, err_msg=k)


def test_sharded_checkpoint_restores_off_the_mesh(two_ranks, ckpt_dir):
    saved = [r["train"][CKPT_CASE] for r in two_ranks]
    with use_mesh(None):
        got = _restore(ckpt_dir)
    assert got["step"] == STEPS and all(v is None for v in got["shards"].values())
    for n, p in lm.gather_params(saved).items():
        np.testing.assert_array_equal(got["params"][n], p, err_msg=n)
    for k, w in _gathered_opt(saved).items():
        np.testing.assert_array_equal(got["opt"][k], w, err_msg=k)
