"""Model assembly for every block kind of ``repro``: ``attn`` (pre-norm GQA
attention + gated MLP), ``mla`` (multi-head latent attention + MLP,
minicpm3), ``moe`` (attention + mixture-of-experts, qwen3-moe and
llama4-scout), ``ssm`` (the Mamba-2 SSD block) and ``rec`` (the RG-LRU
recurrent block + MLP), and the hybrid layout of recurrentgemma: layer i has
kind ``pattern[i % len(pattern)]``, and its attention layers use the local
window ``hybrid.window``.

A port of ``repro.models.transformer``.  Parameters live in ``nn.Module``s
whose attribute names are the JAX tree's keys (``layers[i].attn.wq`` ↔
``params["layers"]["attn"]["wq"][i]``); ``repro`` stacks the layers on axis 0
for ``lax.scan`` (a hybrid stacks its (rec, rec, attn) super-blocks, keyed
``rec_0`` / ``rec_1`` / ``attn_2``, and keeps the remainder as ``tail_0``,
``tail_1``: :func:`leaf_layout`), the port keeps them in one ``ModuleList``
in layer order and loops.  The functions take the model where ``repro``'s
take the parameter tree.

The modality frontends are ``repro``'s stubs (:func:`embed_inputs`): an
audio model (hubert-xlarge, an encoder) projects precomputed frame
embeddings (B, L, 512) through ``frontend_proj``, puts ``mask_emb`` where
``batch["mask"]`` is set, and reads its logits through ``head`` (no
embedding table); a vision model (internvl2-2b) projects patch embeddings
(B, n_patches, 1024) through ``patch_proj`` and puts them before the
embedded text, so its text and its decode positions start at
``n_patches``.

Training: :func:`loss_fn` is ``repro``'s, the MoE aux terms included.
Parameters are created frozen, for serving (which also runs under
``torch.no_grad``); :func:`set_trainable` turns them on for a train step.
``cfg.remat`` takes effect when autograd records: ``"full"`` recomputes each
layer in the backward (``torch.utils.checkpoint``), ``"dots_saveable"``
recomputes it but keeps the outputs of its matrix products (selective
activation checkpointing: :func:`dots_saveable_policy`), ``"none"`` keeps
its activations.

Tensor parallelism: a :class:`Transformer` built under ``use_mesh(mesh)``
with a ``model`` axis of m > 1 holds only this rank's part of each
parameter (``safe_spec`` of its ``ParamDef`` axes: ``heads``, ``kv_heads``,
``ff`` and ``vocab`` go to ``model`` where m divides them;
:func:`param_shardings` gives the specs), and its forward is
tensor-parallel over those parts (``models/attention.py``,
``models/layers.py``; ``experts`` and ``expert_ff``: ``models/moe.py``;
MLA's ``heads``: ``models/mla.py``).  :func:`init_params` draws each leaf
at its full shape and keeps this rank's part, so a rank's tensors are bit
for bit the slices of the off-mesh init.  That covers block kinds
``"attn"``, ``"moe"`` and ``"mla"`` over token embeddings, in training and
in serving: :func:`prefill`, :func:`decode_step` and :func:`verify_step`
run tensor-parallel, their caches (:func:`init_cache`,
:func:`abstract_cache`, ``prefill``'s) are this rank's parts of
``repro``'s global caches (:class:`MeshCaches`; the KV caches
sequence-sharded under ``kv_shard="seq"``: ``models/attention.py``; MLA's
latent cache by rows: ``models/mla.py``) and their logits this rank's
vocab part (``layers.gather_logits``, ``layers.greedy_tokens``).  Block
kinds ``"ssm"`` and ``"rec"``, the hybrid layout, the frontends and
``ServeEngine`` raise under such a mesh (ROADMAP.md, Queue 1 item 5.6).

:func:`input_defs`, :func:`abstract_inputs`, :func:`abstract_params` and
:func:`abstract_cache` describe a batch, the parameters and the caches as
``ParamDef`` trees and as tensors on the ``meta`` device (shapes and dtypes,
no storage), as ``repro``'s do with ``ShapeDtypeStruct``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.dist.sharding import current_mesh, model_axis, rows_split, safe_spec
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rec_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ArchConfig, ShapeSpec
from repro_torch.models.layers import (
    MLP,
    RMSNorm,
    chunked_softmax_xent,
    embed_apply,
    embed_defs,
    logits_apply,
    make_params,
    mlp_defs,
    rmsnorm_def,
    sharded_axis,
    softmax_xent,
)
from repro_torch.models.param import (
    DTYPES,
    ParamDef,
    Shard,
    abstract_tree,
    INPUT_DTYPES,
    init_,
    local_index,
    local_shape,
    sharding_tree,
    stack_defs,
)

#: each block kind's decode-cache leaves
CACHE_KEYS = {"attn": ("k", "v"), "moe": ("k", "v"), "mla": ("c_kv", "k_rope"),
              "ssm": ("state", "conv"), "rec": ("h", "conv")}

#: weights of the MoE aux losses in :func:`loss_fn`, as ``repro``'s
AUX_WEIGHTS = {"moe_balance": 0.01, "moe_zloss": 1e-3}


def block_kind(cfg: ArchConfig) -> str:
    if cfg.family == "ssm":
        return "ssm"
    if cfg.family == "moe":
        return "moe"
    if cfg.mla is not None:
        return "mla"
    return "attn"


def hybrid_layout(cfg: ArchConfig) -> tuple[int, tuple[str, ...]]:
    """(number of (rec, rec, attn) super-blocks, the remainder's kinds)."""
    pat = cfg.hybrid.pattern
    n_super = cfg.n_layers // len(pat)
    return n_super, pat[: cfg.n_layers - n_super * len(pat)]


def layer_cfg(cfg: ArchConfig) -> ArchConfig:
    """The config each layer runs with: inside a hybrid model the attention
    layers use the local window."""
    return cfg.replace(attn_window=cfg.hybrid.window) if cfg.family == "hybrid" else cfg


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """Each layer's block kind, in layer order."""
    if cfg.family == "hybrid":
        pat = cfg.hybrid.pattern
        return [pat[i % len(pat)] for i in range(cfg.n_layers)]
    return [block_kind(cfg)] * cfg.n_layers


def leaf_layout(cfg: ArchConfig) -> Optional[tuple]:
    """Where each layer's parameters sit in ``repro``'s tree: None for a
    stack of one kind (layer i is index i of ``layers/...``), else, per
    layer, (path prefix, index on the stacked axis or None): a hybrid's
    layer i < 3·n_super is (``layers/{kind}_{i % 3}``, i // 3), a remainder
    layer j is (``tail_j``, None).  ``optim.leaf_path`` reads it."""
    if cfg.family != "hybrid":
        return None
    n_super, rem = hybrid_layout(cfg)
    pat = cfg.hybrid.pattern
    body = [(f"layers/{pat[i % len(pat)]}_{i % len(pat)}", i // len(pat))
            for i in range(n_super * len(pat))]
    return tuple(body + [(f"tail_{j}", None) for j in range(len(rem))])


def block_defs(cfg: ArchConfig, kind: Optional[str] = None) -> dict:
    D = cfg.d_model
    kind = kind or block_kind(cfg)
    if kind == "ssm":
        return {"ln1": rmsnorm_def(D), "ssm": ssm_mod.ssm_defs(cfg)}
    mixer = {"rec": ("rec", rec_mod.rglru_defs), "mla": ("attn", mla_mod.mla_defs)}.get(
        kind, ("attn", attn_mod.attn_defs))
    ffn = ("moe", moe_mod.moe_defs(cfg)) if kind == "moe" else ("mlp", mlp_defs(D, cfg.d_ff, cfg.act))
    return {"ln1": rmsnorm_def(D), mixer[0]: mixer[1](cfg), "ln2": rmsnorm_def(D), ffn[0]: ffn[1]}


MODEL_AXIS_ITEM = "ROADMAP.md, Queue 1 item 5.6"

#: the block kinds that run on a ``model`` mesh axis of m > 1
MODEL_AXIS_KINDS = frozenset({"attn", "mla", "moe"})


def check_model_axis(cfg: ArchConfig, mesh=None) -> None:
    """Raise ``NotImplementedError`` (naming Queue 1 item 5.6) for a config
    the port cannot run tensor-parallel on ``mesh``'s (default: the active
    mesh's) ``model`` axis of m > 1: anything but a stack of one of
    ``MODEL_AXIS_KINDS`` over token embeddings (the hybrid layout mixes
    ``"rec"`` in)."""
    tp = model_axis(mesh)
    if tp is None:
        return
    kinds = set(layer_kinds(cfg))
    if not kinds <= MODEL_AXIS_KINDS or cfg.frontend is not None:
        what = f"frontend {cfg.frontend!r}" if cfg.frontend is not None else f"block kinds {sorted(kinds)}"
        raise NotImplementedError(
            f"{cfg.name}: {what} on a 'model' mesh axis of {tp.size} is not ported; the port runs "
            f"block kinds {sorted(MODEL_AXIS_KINDS)} tensor-parallel ({MODEL_AXIS_ITEM})"
        )


def refuse_model_axis(model, what: str) -> None:
    """Raise for ``what`` (the serving engine) on a model built on a
    ``model`` axis of m > 1: ``repro``'s engine takes no mesh."""
    if getattr(model, "tp", None) is not None:
        raise NotImplementedError(
            f"{what} on a model built on a 'model' mesh axis of {model.tp.size} is not ported "
            f"({MODEL_AXIS_ITEM})"
        )


def frontend_defs(cfg: ArchConfig) -> dict:
    """The parameters before the layers, in ``repro``'s order: an audio
    model's frame projection, mask embedding and head (no embedding table),
    a vision model's patch projection and the token embeddings, else the
    token embeddings."""
    D = cfg.d_model
    if cfg.frontend == "audio":
        return {"frontend_proj": ParamDef((512, D), (None, "embed")),
                "mask_emb": ParamDef((D,), (None,)),
                "head": ParamDef((D, cfg.padded_vocab), ("embed", "vocab"))}
    if cfg.frontend == "vision":
        return {"patch_proj": ParamDef((1024, D), (None, "embed")), **embed_defs(cfg)}
    return dict(embed_defs(cfg))


def param_shardings(cfg: ArchConfig, mesh=None) -> dict:
    """The ``PartitionSpec`` of every leaf of :func:`model_defs` on ``mesh``
    (default: the active mesh), ``repro``'s ``param_shardings``."""
    return sharding_tree(model_defs(cfg), mesh)


def model_defs(cfg: ArchConfig) -> dict:
    """``repro``'s parameter tree of ParamDefs (layers stacked)."""
    defs = frontend_defs(cfg)
    if cfg.family == "hybrid":
        hcfg = layer_cfg(cfg)
        n_super, rem = hybrid_layout(cfg)
        pat = cfg.hybrid.pattern
        defs["layers"] = stack_defs({f"{k}_{i}": block_defs(hcfg, k) for i, k in enumerate(pat)}, n_super)
        for i, k in enumerate(rem):
            defs[f"tail_{i}"] = block_defs(hcfg, k)
    else:
        defs["layers"] = stack_defs(block_defs(cfg), cfg.n_layers)
    defs["final_norm"] = rmsnorm_def(cfg.d_model)
    return defs


class Block(nn.Module):
    """Block kinds ``attn``, ``mla`` and ``moe``: rmsnorm → attention (GQA
    or MLA), residual; rmsnorm → gated MLP or mixture of experts, residual.
    ``forward`` → (x, cache | None, MoE aux losses | None)."""

    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype, device, kind: str = "attn"):
        super().__init__()
        self.kind = kind
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        mixer = mla_mod.MLA if kind == "mla" else attn_mod.Attention
        self.attn = mixer(cfg, dtype=dtype, device=device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        if kind == "moe":
            self.moe = moe_mod.MoE(cfg, dtype=dtype, device=device)
        else:
            self.mlp = MLP(cfg, dtype=dtype, device=device)

    def _ffn(self, x, cfg: ArchConfig, rows, want_aux: bool):
        if self.kind == "moe":
            return moe_mod.moe_apply(self.moe, self.ln2(x), cfg, rows, want_aux)
        return self.mlp(self.ln2(x)), None

    def forward(self, x, positions, cfg: ArchConfig, *, causal: bool, want_cache: bool, rows=None,
                want_aux: bool = True):
        """``rows``: the split of the step's rows over the batch axes, which
        a MoE routes over (``dist.sharding.rows_split``; None: whole);
        ``want_aux``: whether a MoE computes its aux losses."""
        apply = mla_mod.mla_apply if self.kind == "mla" else attn_mod.attention_apply
        h, cache = apply(self.attn, self.ln1(x), positions, cfg, causal=causal, want_cache=want_cache)
        x = x + h
        h, aux = self._ffn(x, cfg, rows, want_aux)
        return x + h, cache, aux

    def decode(self, x, cache: dict, pos: torch.Tensor, cfg: ArchConfig, part=None, rows=None):
        """``part``: the KV (or MLA latent) cache's place on the ``model``
        axis (``attention.KVPart``; None off it); ``rows`` as for
        :meth:`forward`."""
        step = mla_mod.mla_decode_step if self.kind == "mla" else attn_mod.attention_decode_step
        h, cache = step(self.attn, self.ln1(x), cache, pos, cfg, *(() if part is None else (part,)))
        x = x + h
        return x + self._ffn(x, cfg, rows, False)[0], cache


class RecBlock(nn.Module):
    """Block kind ``rec``: rmsnorm → RG-LRU block, residual; rmsnorm → gated
    MLP, residual."""

    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        self.rec = rec_mod.RGLRU(cfg, dtype=dtype, device=device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        self.mlp = MLP(cfg, dtype=dtype, device=device)

    def forward(self, x, positions, cfg: ArchConfig, *, causal: bool, want_cache: bool):
        h, cache = rec_mod.rglru_apply(self.rec, self.ln1(x), cfg, want_cache=want_cache)
        x = x + h
        return x + self.mlp(self.ln2(x)), cache, None

    def decode(self, x, cache: dict, pos: torch.Tensor, cfg: ArchConfig):
        h, cache = rec_mod.rglru_decode_step(self.rec, self.ln1(x), cache, cfg)
        x = x + h
        return x + self.mlp(self.ln2(x)), cache


class SSMBlock(nn.Module):
    """Block kind ``ssm``: rmsnorm → SSD mixer, residual (no MLP)."""

    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        self.ssm = ssm_mod.SSM(cfg, dtype=dtype, device=device)

    def forward(self, x, positions, cfg: ArchConfig, *, causal: bool, want_cache: bool):
        h, cache = ssm_mod.ssm_apply(self.ssm, self.ln1(x), cfg, want_cache=want_cache)
        return x + h, cache, None

    def decode(self, x, cache: dict, pos: torch.Tensor, cfg: ArchConfig):
        h, cache = ssm_mod.ssm_decode_step(self.ssm, self.ln1(x), cache, cfg)
        return x + h, cache


def _make_block(cfg: ArchConfig, kind: str, *, dtype, device) -> nn.Module:
    if kind == "ssm":
        return SSMBlock(cfg, dtype=dtype, device=device)
    if kind == "rec":
        return RecBlock(cfg, dtype=dtype, device=device)
    return Block(cfg, dtype=dtype, device=device, kind=kind)


class Transformer(nn.Module):
    """Uninitialised (``torch.empty``) parameters; see :func:`init_params`.
    ``leaf_layout`` maps the layers onto ``repro``'s tree (:func:`leaf_layout`).
    ``device="meta"`` builds the module of shapes alone (a dry run,
    ``launch/dryrun.py``): nothing launches there, since a kernel wrapper
    given ``meta`` tensors takes its meta route (``kernels/dispatch.py``).

    Built under a mesh with a ``model`` axis of m > 1 (module docstring),
    ``tp`` is that axis (``dist.sharding.ModelAxis``; None otherwise),
    ``vocab_tp`` is it when ``vocab`` is sharded, and ``shards`` maps each
    parameter name to its :class:`~repro_torch.models.param.Shard` (full
    shape, spec, this rank's index; the index is None on a mesh-like
    object without ranks)."""

    def __init__(self, cfg: ArchConfig, *, device="cuda"):
        super().__init__()
        check_model_axis(cfg)
        device = torch.device(device)
        if device.type != "meta":
            device = resolve_device(device)
        dtype = DTYPES[cfg.dtype]
        self.cfg = cfg
        self.leaf_layout = leaf_layout(cfg)
        self.tp = model_axis()
        fdefs = frontend_defs(cfg)
        make_params(self, fdefs, dtype=dtype, device=device)
        self.vocab_tp = sharded_axis(fdefs["embedding"], 0) if "embedding" in fdefs else None
        lcfg = layer_cfg(cfg)
        self.layers = nn.ModuleList(
            _make_block(lcfg, kind, dtype=dtype, device=device) for kind in layer_kinds(cfg)
        )
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        self.shards = None
        if self.tp is not None:
            mesh = self.tp.mesh
            ranked = hasattr(mesh, "get_local_rank")
            self.shards = {}
            for name, _, d in named_defs(self):
                spec = safe_spec(d.shape, d.axes, mesh=mesh)
                self.shards[name] = Shard(tuple(d.shape), spec,
                                          local_index(d.shape, spec, mesh) if ranked else None)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device  # an audio model has no embedding


def _target(module: nn.Module, name: str) -> tuple[str, torch.Tensor]:
    """The parameter a JAX tree key names under ``module`` (norms hold
    ``scale``): (its name under ``module``, the tensor)."""
    t = getattr(module, name)
    return (f"{name}.scale", t.scale) if isinstance(t, RMSNorm) else (name, t)


def _walk(module: nn.Module, defs: dict, prefix: str = ""):
    for name, d in defs.items():
        if isinstance(d, ParamDef):
            local, t = _target(module, name)
            yield prefix + local, t, d
        else:
            yield from _walk(getattr(module, name), d, f"{prefix}{name}.")


def named_defs(model: Transformer):
    """(parameter name, tensor, its unstacked ``ParamDef``) for every
    parameter, in ``repro``'s tree order: the frontend and embeddings, the
    layers in order, the final norm (the order the init draws them)."""
    cfg = model.cfg
    yield from _walk(model, frontend_defs(cfg))
    lcfg = layer_cfg(cfg)
    for i, (layer, kind) in enumerate(zip(model.layers, layer_kinds(cfg))):
        yield from _walk(layer, block_defs(lcfg, kind), f"layers.{i}.")
    yield from _walk(model, {"final_norm": rmsnorm_def(cfg.d_model)})


def partial_grad_names(model: Transformer) -> tuple[str, ...]:
    """Parameters replicated over the ``model`` axis whose gradient each
    rank holds a part of (``attention.partial_grad_names``): the train step
    sums them over ``model``.  Empty off a ``model`` axis."""
    out = []
    for i, layer in enumerate(model.layers):
        attn = getattr(layer, "attn", None)
        if isinstance(attn, attn_mod.Attention):
            out += [f"layers.{i}.attn.{n}" for n in attn_mod.partial_grad_names(attn)]
    return tuple(out)


def set_trainable(model: nn.Module) -> nn.Module:
    """Turn gradients on for every parameter (they are created frozen, for
    serving)."""
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def init_params(cfg: ArchConfig, seed: int = 0, *, device="cuda") -> Transformer:
    """A :class:`Transformer` with ``repro``'s init rules, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed``, one leaf at a time in
    ``repro``'s tree order; on a ``model`` axis each leaf is drawn whole and
    this rank's part kept (bit for bit the off-mesh init's slice)."""
    model = Transformer(cfg, device=device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for name, t, d in named_defs(model):
        init_(t, d, gen, None if model.shards is None else model.shards[name].index)
    return model


# ---------------------------------------------------------------------------
# Forward (prefill) and decode
# ---------------------------------------------------------------------------

#: the matrix products whose outputs ``remat="dots_saveable"`` keeps: every
#: ``x @ w`` and einsum of the port reaches one of these
DOT_OPS = frozenset({torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm, torch.ops.aten.baddbmm})


def dots_saveable_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``jax.checkpoint_policies.dots_saveable``: keep the output of every
    matrix product, recompute everything else.  The CUDA kernels launch
    through ctypes inside ``autograd.Function``s, not as aten ops, so they
    are recomputed (on the TPU a ``pallas_call``'s output is not a dot
    either)."""
    return CheckpointPolicy.MUST_SAVE if op.overloadpacket in DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(layer: nn.Module, cfg: ArchConfig):
    """The layer as the forward calls it: recomputed in the backward under
    ``remat="full"`` (``torch.utils.checkpoint``), recomputed but for its
    matrix products' outputs under ``"dots_saveable"``, when autograd
    records; as it is otherwise."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return layer
    if cfg.remat == "dots_saveable":
        context_fn = functools.partial(create_selective_checkpoint_contexts, dots_saveable_policy)
        return lambda *args, **kw: checkpoint(layer, *args, use_reentrant=False, context_fn=context_fn, **kw)
    if cfg.remat != "full":
        raise ValueError(f"unknown remat {cfg.remat!r}; use 'none', 'full' or 'dots_saveable'")
    return lambda *args, **kw: checkpoint(layer, *args, use_reentrant=False, **kw)


def _add_aux(total: Optional[dict], aux: Optional[dict]) -> Optional[dict]:
    if aux is None:
        return total
    return aux if total is None else {k: total[k] + aux[k] for k in total}


def embed_inputs(model: Transformer, batch: dict, cfg: ArchConfig):
    """→ (x (B, L, D), positions (B, L)), as ``repro``'s: the embedded
    tokens; for an audio model the frame embeddings ``batch["embeds"]`` (B,
    L, 512) projected, with ``mask_emb`` where ``batch["mask"]`` is set;
    for a vision model the projected ``batch["patch_embeds"]`` (B,
    n_patches, 1024) followed by the embedded text.  Positions count over
    the whole sequence."""
    dtype = DTYPES[cfg.dtype]
    if cfg.frontend == "audio":
        x = batch["embeds"].to(dtype) @ model.frontend_proj
        if "mask" in batch:
            x = torch.where(batch["mask"][..., None], model.mask_emb.to(x.dtype), x)
    elif cfg.frontend == "vision":
        patches = batch["patch_embeds"].to(dtype) @ model.patch_proj
        x = torch.cat([patches, embed_apply(model, batch["tokens"], cfg)], dim=1)
    else:
        x = embed_apply(model, batch["tokens"], cfg)
    B, L = x.shape[:2]
    positions = torch.arange(L, dtype=torch.int32, device=x.device).expand(B, L)
    return x, positions


def head_logits(model: Transformer, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Logits of hidden states ``x`` (..., D): an audio model's ``x @
    head`` over the padded classes (``repro`` masks no padding class and
    applies no softcap there), else :func:`~repro_torch.models.layers.logits_apply`."""
    if cfg.frontend == "audio":
        return x @ model.head
    return logits_apply(model, x, cfg)


def forward(model: Transformer, batch: dict, cfg: ArchConfig, *, want_cache: bool = False,
            want_aux: bool = True):
    """→ (hidden (B, L, D), caches | None, aux).  ``batch`` is
    :func:`embed_inputs`'s (``tokens``; ``embeds`` / ``mask`` for audio;
    ``patch_embeds`` and ``tokens`` for vision, L = n_patches + tokens).
    ``caches`` is one flat
    dict of leaves stacked over the layers of the kind that owns them, in
    layer order (:func:`cache_defs`'s shapes with the prompt's L for the
    sequence axis): ``{'k', 'v'}: (n, B, L, KH, Dh)`` for attention,
    ``{'c_kv': (n, B, L, r_kv), 'k_rope': (n, B, L, d_rope)}`` for MLA,
    ``{'state', 'conv'}`` for ssm, ``{'h': (n, B, W) float32, 'conv': (n,
    B, 3, W)}`` for rec; a hybrid's dict holds both its kinds' leaves.
    ``aux`` is the MoE aux losses summed over the layers ({} without MoE
    or ``want_aux``)."""
    x, positions = embed_inputs(model, batch, cfg)
    causal = not cfg.is_encoder
    lcfg = layer_cfg(cfg)
    # read here, in the calling thread, and passed to the layers: a
    # recomputation in the backward may run on autograd's threads
    moe_kw = {"rows": rows_split(), "want_aux": want_aux} if cfg.moe is not None else {}
    layer_caches, aux = [], None
    for layer in model.layers:
        x, cache, a = _remat(layer, cfg)(x, positions, lcfg, causal=causal, want_cache=want_cache, **moe_kw)
        aux = _add_aux(aux, a)
        if want_cache:
            layer_caches.append(cache)
    x = model.final_norm(x)
    caches = None
    if want_cache:
        caches = {k: torch.stack([c[k] for c in layer_caches if k in c])
                  for k in dict.fromkeys(k for c in layer_caches for k in c)}
    return x, caches, aux or {}


def loss_fn(model: Transformer, batch: dict, cfg: ArchConfig):
    """→ (total loss, metrics): mean cross-entropy over ``batch["labels"]``
    (masked by ``batch["mask"]`` when present): an audio model's over every
    frame through ``head`` (masked prediction), a vision model's over the
    text positions (the last ``labels.shape[1]``), chunked over the
    sequence when ``cfg.logits_chunk`` is set (not for audio, as in
    ``repro``); a MoE model adds ``AUX_WEIGHTS``-weighted aux losses
    averaged over the layers.  Metrics: ``ce_loss``, and ``moe_balance`` /
    ``moe_zloss`` for MoE."""
    x, _, aux = forward(model, batch, cfg)
    labels, mask = batch["labels"], batch.get("mask")
    if cfg.frontend == "vision":
        x = x[:, -labels.shape[1]:]
    if cfg.frontend == "audio":
        loss = softmax_xent(head_logits(model, x, cfg), labels, mask)
    elif cfg.logits_chunk:
        loss = chunked_softmax_xent(x, labels, model, cfg, mask, chunk=cfg.logits_chunk)
    else:
        loss = softmax_xent(logits_apply(model, x, cfg), labels, mask, tp=model.vocab_tp)
    total, metrics = loss, {"ce_loss": loss}
    if cfg.family == "moe":
        for k, w in AUX_WEIGHTS.items():
            total = total + w * aux[k] / cfg.n_layers
            metrics[k] = aux[k] / cfg.n_layers
    return total, metrics


class MeshCaches(dict):
    """Decode caches on a ``model`` axis of m > 1: this rank's part of each
    leaf of ``repro``'s global caches, and ``seq_len``, the global rows of
    the KV (or MLA latent) leaves' sequence axis, which places each rank's
    part (``attention.kv_part``, ``mla.latent_part``): a local shape alone
    cannot tell a sequence-sharded cache from a whole one of fewer rows."""

    def __init__(self, leaves: dict, seq_len: int):
        super().__init__(leaves)
        self.seq_len = seq_len


@torch.no_grad()
def prefill(model: Transformer, batch: dict, cfg: ArchConfig):
    """→ (last-position logits (B, 1, V), caches).  Only the final
    position's logits are computed.  On a ``model`` axis the logits are
    this rank's vocab part and the caches a :class:`MeshCaches` of the
    prompt's rows."""
    x, caches, _ = forward(model, batch, cfg, want_cache=True, want_aux=False)
    tp = getattr(model, "tp", None)  # (a speculative draft shares a model's modules without one)
    if tp is not None:
        caches = MeshCaches(caches, x.shape[1])
    return head_logits(model, x[:, -1:], cfg), caches


def _pos_vector(pos, batch: int, device) -> torch.Tensor:
    """Scalar or (B,) position → a contiguous (B,) int32 tensor on ``device``."""
    if isinstance(pos, torch.Tensor):
        p = pos.to(device=device, dtype=torch.int32)
        return p.expand(batch).contiguous() if p.ndim == 0 else p.contiguous()
    return torch.full((batch,), int(pos), dtype=torch.int32, device=device)


@torch.no_grad()
def decode_step(model: Transformer, tokens: torch.Tensor, caches: dict, pos, cfg: ArchConfig):
    """One decode step.  tokens (B, 1) int; pos a scalar or a (B,) tensor of
    current positions; caches stacked on the layer axis (:func:`cache_defs`),
    **updated in place**.  → (logits (B, 1, V), caches).  On a ``model``
    axis ``caches`` is a :class:`MeshCaches` and the logits are this rank's
    vocab part."""
    x = embed_apply(model, tokens, cfg)
    pos_b = _pos_vector(pos, tokens.shape[0], tokens.device)
    lcfg = layer_cfg(cfg)
    parts = None
    tp = getattr(model, "tp", None)
    if tp is not None:
        if not isinstance(caches, MeshCaches):
            raise ValueError("decode on a 'model' axis takes the MeshCaches that init_cache, prefill or "
                             "runtime.serve.prime_cache make: their global rows place each rank's part")
        place = {"mla": mla_mod.latent_part}  # the others' caches are KV caches
        parts = {kind: place.get(kind, attn_mod.kv_part)(lcfg, caches.seq_len, tp)
                 for kind in set(layer_kinds(cfg))}
    rows = rows_split() if cfg.moe is not None else None
    seen: dict = {}  # layers of each kind so far: the index into its leaves
    for layer, kind in zip(model.layers, layer_kinds(cfg)):
        j = seen[kind] = seen.get(kind, -1) + 1
        kw = {} if parts is None else {"part": parts[kind]}
        if kind == "moe":
            kw["rows"] = rows
        x, _ = layer.decode(x, {k: caches[k][j] for k in CACHE_KEYS[kind]}, pos_b, lcfg, **kw)
    x = model.final_norm(x)
    return logits_apply(model, x, cfg), caches


@torch.no_grad()
def verify_step(model: Transformer, tokens: torch.Tensor, caches: dict, pos, cfg: ArchConfig,
                advance=None):
    """Multi-position decode for speculative-decoding verification: feeds
    ``tokens`` (B, T) one position at a time, sub-step ``j`` at ``pos +
    j·advance`` (``advance`` a (B,) 0/1 vector, all ones when None; a slot
    with 0 re-feeds its token at the same position, an idempotent KV row
    rewrite).  → (logits (B, T, V), caches updated in place).

    The loop body is :func:`decode_step` itself, at the plain decode's
    shapes, so each position's logits are bit for bit the plain decode's:
    batching the T positions into one forward would change the matrix
    products' shapes, and with them the bits.  The positions are formed on
    the device from one (B,) ``pos`` and ``advance``."""
    B, T = tokens.shape
    pos_b = _pos_vector(pos, B, tokens.device)
    adv = torch.ones_like(pos_b) if advance is None else _pos_vector(advance, B, tokens.device)
    outs = []
    for j in range(T):
        logits_j, caches = decode_step(model, tokens[:, j:j + 1], caches, pos_b + j * adv, cfg)
        outs.append(logits_j)
    return torch.cat(outs, dim=1), caches


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _cache_leaf_defs(cfg: ArchConfig, kind: str, batch: int, max_seq: int) -> dict:
    if kind == "ssm":
        return ssm_mod.ssm_cache_defs(cfg, batch)
    if kind == "rec":
        return rec_mod.rglru_cache_defs(cfg, batch)
    if kind == "mla":
        return mla_mod.mla_cache_defs(cfg, batch, max_seq)
    sh = attn_mod.kv_cache_shape(cfg, batch, max_seq)  # a ring of the window when windowed
    ax = attn_mod.kv_cache_axes(cfg)
    return {"k": ParamDef(sh, ax, dtype=cfg.dtype), "v": ParamDef(sh, ax, dtype=cfg.dtype)}


def cache_defs(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """The decode caches: one flat dict whose leaves are stacked over the
    layers of the kind that owns them (axis 0), with the batch slot on axis
    1.  A hybrid's ``h`` / ``conv`` stack its rec layers and its ``k`` /
    ``v`` (rings of the window) its attention layers."""
    lcfg = layer_cfg(cfg)
    kinds = layer_kinds(cfg)
    out: dict = {}
    for kind in dict.fromkeys(kinds):
        leaves = _cache_leaf_defs(lcfg, kind, batch, max_seq)
        out.update(stack_defs(leaves, kinds.count(kind)))
    return out


def cache_layout(cfg: ArchConfig) -> Optional[dict]:
    """Per-leaf ``(batch_axis, seq_axis)`` of the stacked decode caches, the
    plumbing the paged serving tier needs: MLA pages its latent rows
    (``c_kv``, ``k_rope``).  None for an ssm or rec state (one vector per
    sequence, not per token), for a ring-buffered (windowed) cache, whose
    slots fold positions modulo the window, and so for a hybrid."""
    kind = block_kind(cfg)
    if cfg.family == "hybrid" or kind == "ssm" or cfg.attn_window is not None:
        return None
    return {k: (1, 2) for k in CACHE_KEYS[kind]}


def _local_caches(cfg: ArchConfig, batch: int, max_seq: int, make) -> dict:
    """``make(shape, dtype)`` for each leaf of :func:`cache_defs`, at this
    rank's part of its shape under the active mesh (``safe_spec``: the first
    dimension wins, what the mesh cannot divide is replicated), as
    :class:`MeshCaches` on a ``model`` axis of m > 1."""
    mesh = current_mesh()
    out = {}
    for name, d in cache_defs(cfg, batch, max_seq).items():
        shape = d.shape if mesh is None else local_shape(d.shape, safe_spec(d.shape, d.axes, mesh=mesh), mesh)
        out[name] = make(shape, INPUT_DTYPES[d.dtype or cfg.dtype])
    if model_axis(mesh) is None:
        return out
    return MeshCaches(out, attn_mod.kv_cache_shape(layer_cfg(cfg), batch, max_seq)[1])


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *, device="cuda") -> dict:
    """Zeroed decode caches on ``device``: :func:`cache_defs`' shapes, this
    rank's parts under a mesh (:func:`_local_caches`)."""
    device = resolve_device(device)
    return _local_caches(cfg, batch, max_seq, lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=device))


def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """:func:`cache_defs` as ``meta`` tensors (this rank's parts under a
    mesh)."""
    return _local_caches(cfg, batch, max_seq, lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta"))


# ---------------------------------------------------------------------------
# Abstract parameters and input specs
# ---------------------------------------------------------------------------

def abstract_params(cfg: ArchConfig) -> dict:
    """:func:`model_defs` as ``meta`` tensors (``repro``'s tree, layers
    stacked).  ``Transformer(cfg, device="meta")`` is the module form."""
    return abstract_tree(model_defs(cfg), cfg.dtype)


def input_defs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """ParamDef tree for one batch of inputs under ``shape``, as
    ``repro``'s: tokens (and labels for train); an audio model's frame
    embeddings, mask and labels; a vision model's text tokens, patch
    embeddings (and text labels), n_patches + text = ``shape.seq_len``."""
    B, L = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ParamDef((B, 1), ("batch", None), dtype="int32")}
    if cfg.frontend == "audio":
        return {
            "embeds": ParamDef((B, L, 512), ("batch", None, None), dtype=cfg.dtype),
            "mask": ParamDef((B, L), ("batch", None), dtype="bool"),
            "labels": ParamDef((B, L), ("batch", None), dtype="int32"),
        }
    if cfg.frontend == "vision":
        lt = L - cfg.n_patches
        out = {
            "tokens": ParamDef((B, lt), ("batch", None), dtype="int32"),
            "patch_embeds": ParamDef((B, cfg.n_patches, 1024), ("batch", None, None), dtype=cfg.dtype),
        }
        if shape.kind == "train":
            out["labels"] = ParamDef((B, lt), ("batch", None), dtype="int32")
        return out
    out = {"tokens": ParamDef((B, L), ("batch", None), dtype="int32")}
    if shape.kind == "train":
        out["labels"] = ParamDef((B, L), ("batch", None), dtype="int32")
    return out


def abstract_inputs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """:func:`input_defs` as ``meta`` tensors."""
    return abstract_tree(input_defs(cfg, shape), cfg.dtype)
