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

Training: :func:`loss_fn` is ``repro``'s, the MoE aux terms included.
Parameters are created frozen, for serving (which also runs under
``torch.no_grad``); :func:`set_trainable` turns them on for a train step.
``cfg.remat`` takes effect when autograd records: ``"full"`` recomputes each
layer in the backward (``torch.utils.checkpoint``), ``"none"`` keeps its
activations.

The audio and vision frontends (hubert-xlarge, internvl2-2b) raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rec_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ArchConfig
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
    softmax_xent,
)
from repro_torch.models.param import DTYPES, ParamDef, init_, stack_defs

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


def check_supported(cfg: ArchConfig) -> None:
    """The port runs every block kind with a token frontend."""
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: frontend {cfg.frontend!r} is not ported yet (ROADMAP.md, port "
            "queue: 'Other families')"
        )


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


def model_defs(cfg: ArchConfig) -> dict:
    """``repro``'s parameter tree of ParamDefs (layers stacked)."""
    check_supported(cfg)
    defs: dict = dict(embed_defs(cfg))
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

    def _ffn(self, x, cfg: ArchConfig):
        if self.kind == "moe":
            return moe_mod.moe_apply(self.moe, self.ln2(x), cfg)
        return self.mlp(self.ln2(x)), None

    def forward(self, x, positions, cfg: ArchConfig, *, causal: bool, want_cache: bool):
        apply = mla_mod.mla_apply if self.kind == "mla" else attn_mod.attention_apply
        h, cache = apply(self.attn, self.ln1(x), positions, cfg, causal=causal, want_cache=want_cache)
        x = x + h
        h, aux = self._ffn(x, cfg)
        return x + h, cache, aux

    def decode(self, x, cache: dict, pos: torch.Tensor, cfg: ArchConfig):
        step = mla_mod.mla_decode_step if self.kind == "mla" else attn_mod.attention_decode_step
        h, cache = step(self.attn, self.ln1(x), cache, pos, cfg)
        x = x + h
        return x + self._ffn(x, cfg)[0], cache


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
    ``leaf_layout`` maps the layers onto ``repro``'s tree (:func:`leaf_layout`)."""

    def __init__(self, cfg: ArchConfig, *, device="cuda"):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        dtype = DTYPES[cfg.dtype]
        self.cfg = cfg
        self.leaf_layout = leaf_layout(cfg)
        make_params(self, embed_defs(cfg), dtype=dtype, device=device)
        lcfg = layer_cfg(cfg)
        self.layers = nn.ModuleList(
            _make_block(lcfg, kind, dtype=dtype, device=device) for kind in layer_kinds(cfg)
        )
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)

    @property
    def device(self) -> torch.device:
        return self.embedding.device


def _target(module: nn.Module, name: str) -> torch.Tensor:
    """The tensor a JAX tree key names under ``module`` (norms hold ``scale``)."""
    t = getattr(module, name)
    return t.scale if isinstance(t, RMSNorm) else t


def _walk_init(module: nn.Module, defs: dict, gen: torch.Generator) -> None:
    for name, d in defs.items():
        if isinstance(d, ParamDef):
            init_(_target(module, name), d, gen)
        else:
            _walk_init(getattr(module, name), d, gen)


def set_trainable(model: nn.Module) -> nn.Module:
    """Turn gradients on for every parameter (they are created frozen, for
    serving)."""
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def init_params(cfg: ArchConfig, seed: int = 0, *, device="cuda") -> Transformer:
    """A :class:`Transformer` with ``repro``'s init rules, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed``."""
    model = Transformer(cfg, device=device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    # repro's tree order: embeddings, the layers in order, the final norm
    _walk_init(model, embed_defs(cfg), gen)
    lcfg = layer_cfg(cfg)
    for layer, kind in zip(model.layers, layer_kinds(cfg)):
        _walk_init(layer, block_defs(lcfg, kind), gen)
    _walk_init(model, {"final_norm": rmsnorm_def(cfg.d_model)}, gen)
    return model


# ---------------------------------------------------------------------------
# Forward (prefill) and decode
# ---------------------------------------------------------------------------

def _remat(layer: nn.Module, cfg: ArchConfig):
    """The layer as the forward calls it: recomputed in the backward under
    ``remat="full"`` when autograd records, as it is otherwise."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return layer
    if cfg.remat == "dots_saveable":
        raise NotImplementedError(
            "remat='dots_saveable' is not ported yet (ROADMAP.md, port queue: "
            "'remat=\"dots_saveable\"'); use 'full' or 'none'"
        )
    if cfg.remat != "full":
        raise ValueError(f"unknown remat {cfg.remat!r}; use 'none', 'full' or 'dots_saveable'")
    return lambda *args, **kw: checkpoint(layer, *args, use_reentrant=False, **kw)


def _add_aux(total: Optional[dict], aux: Optional[dict]) -> Optional[dict]:
    if aux is None:
        return total
    return aux if total is None else {k: total[k] + aux[k] for k in total}


def forward(model: Transformer, batch: dict, cfg: ArchConfig, *, want_cache: bool = False):
    """→ (hidden (B, L, D), caches | None, aux).  ``caches`` is one flat
    dict of leaves stacked over the layers of the kind that owns them, in
    layer order (:func:`cache_defs`'s shapes with the prompt's L for the
    sequence axis): ``{'k', 'v'}: (n, B, L, KH, Dh)`` for attention,
    ``{'c_kv': (n, B, L, r_kv), 'k_rope': (n, B, L, d_rope)}`` for MLA,
    ``{'state', 'conv'}`` for ssm, ``{'h': (n, B, W) float32, 'conv': (n,
    B, 3, W)}`` for rec; a hybrid's dict holds both its kinds' leaves.
    ``aux`` is the MoE aux losses summed over the layers ({} without MoE)."""
    tokens = batch["tokens"]
    x = embed_apply(model, tokens, cfg)
    B, L = tokens.shape
    positions = torch.arange(L, dtype=torch.int32, device=tokens.device).expand(B, L)
    causal = not cfg.is_encoder
    lcfg = layer_cfg(cfg)
    layer_caches, aux = [], None
    for layer in model.layers:
        x, cache, a = _remat(layer, cfg)(x, positions, lcfg, causal=causal, want_cache=want_cache)
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
    """→ (total loss, metrics): mean next-token cross-entropy over
    ``batch["labels"]`` (masked by ``batch["mask"]`` when present), chunked
    over the sequence when ``cfg.logits_chunk`` is set; a MoE model adds
    ``AUX_WEIGHTS``-weighted aux losses averaged over the layers.  Metrics:
    ``ce_loss``, and ``moe_balance`` / ``moe_zloss`` for MoE."""
    x, _, aux = forward(model, batch, cfg)
    labels, mask = batch["labels"], batch.get("mask")
    if cfg.logits_chunk:
        loss = chunked_softmax_xent(x, labels, model, cfg, mask, chunk=cfg.logits_chunk)
    else:
        loss = softmax_xent(logits_apply(model, x, cfg), labels, mask)
    total, metrics = loss, {"ce_loss": loss}
    if cfg.family == "moe":
        for k, w in AUX_WEIGHTS.items():
            total = total + w * aux[k] / cfg.n_layers
            metrics[k] = aux[k] / cfg.n_layers
    return total, metrics


@torch.no_grad()
def prefill(model: Transformer, batch: dict, cfg: ArchConfig):
    """→ (last-token logits (B, 1, V), caches).  Only the final position's
    logits are computed."""
    x, caches, _ = forward(model, batch, cfg, want_cache=True)
    return logits_apply(model, x[:, -1:], cfg), caches


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
    **updated in place**.  → (logits (B, 1, V), caches)."""
    x = embed_apply(model, tokens, cfg)
    pos_b = _pos_vector(pos, tokens.shape[0], tokens.device)
    lcfg = layer_cfg(cfg)
    seen: dict = {}  # layers of each kind so far: the index into its leaves
    for layer, kind in zip(model.layers, layer_kinds(cfg)):
        j = seen[kind] = seen.get(kind, -1) + 1
        x, _ = layer.decode(x, {k: caches[k][j] for k in CACHE_KEYS[kind]}, pos_b, lcfg)
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
    ax = ("batch", "kv_seq", "kv_heads", None)
    return {"k": ParamDef(sh, ax, dtype=cfg.dtype), "v": ParamDef(sh, ax, dtype=cfg.dtype)}


def cache_defs(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """The decode caches: one flat dict whose leaves are stacked over the
    layers of the kind that owns them (axis 0), with the batch slot on axis
    1.  A hybrid's ``h`` / ``conv`` stack its rec layers and its ``k`` /
    ``v`` (rings of the window) its attention layers."""
    check_supported(cfg)
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
    check_supported(cfg)
    kind = block_kind(cfg)
    if cfg.family == "hybrid" or kind == "ssm" or cfg.attn_window is not None:
        return None
    return {k: (1, 2) for k in CACHE_KEYS[kind]}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *, device="cuda") -> dict:
    device = resolve_device(device)
    return {
        name: torch.zeros(d.shape, dtype=DTYPES[d.dtype], device=device)
        for name, d in cache_defs(cfg, batch, max_seq).items()
    }
