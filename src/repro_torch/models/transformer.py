"""Model assembly for block kinds ``"attn"`` and ``"ssm"``: the dense
decoder-only transformer (embed → per layer rmsnorm → GQA attention with RoPE
→ rmsnorm → gated MLP → final rmsnorm → logits) and the Mamba-2 stack (embed
→ per layer rmsnorm → SSD mixer → final rmsnorm → logits).

A port of ``repro.models.transformer``.  Parameters live in ``nn.Module``s
whose attribute names are the JAX tree's keys (``layers[i].attn.wq`` ↔
``params["layers"]["attn"]["wq"][i]``); ``repro`` stacks the layers on axis 0
for ``lax.scan``, the port keeps them in a ``ModuleList`` and loops.  The
functions take the model where ``repro``'s take the parameter tree.

Training: :func:`loss_fn` is ``repro``'s (the dense model has no aux
losses).  Parameters are created frozen, for serving (which also runs under
``torch.no_grad``); :func:`set_trainable` turns them on for a train step.
``cfg.remat`` takes effect when autograd records: ``"full"`` recomputes each
layer in the backward (``torch.utils.checkpoint``), ``"none"`` keeps its
activations.

The other block kinds (``mla``, ``moe``, ``rec``), hybrid stacks and
frontends raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import attention as attn_mod
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
from repro_torch.models.param import DTYPES, ParamDef, init_, stack_defs, unstack_def


def block_kind(cfg: ArchConfig) -> str:
    if cfg.family == "ssm":
        return "ssm"
    if cfg.family == "moe":
        return "moe"
    if cfg.mla is not None:
        return "mla"
    return "attn"


def check_supported(cfg: ArchConfig) -> None:
    """The port runs block kinds ``attn`` and ``ssm`` with a token frontend only."""
    kind = "hybrid" if cfg.family == "hybrid" else block_kind(cfg)
    if kind not in ("attn", "ssm") or cfg.frontend is not None:
        what = kind if kind not in ("attn", "ssm") else f"frontend {cfg.frontend!r}"
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported yet (ROADMAP.md, port queue: "
            "'Other families')"
        )


def block_defs(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    if block_kind(cfg) == "ssm":
        return {"ln1": rmsnorm_def(D), "ssm": ssm_mod.ssm_defs(cfg)}
    return {
        "ln1": rmsnorm_def(D),
        "attn": attn_mod.attn_defs(cfg),
        "ln2": rmsnorm_def(D),
        "mlp": mlp_defs(D, cfg.d_ff, cfg.act),
    }


def model_defs(cfg: ArchConfig) -> dict:
    check_supported(cfg)
    defs: dict = dict(embed_defs(cfg))
    defs["layers"] = stack_defs(block_defs(cfg), cfg.n_layers)
    defs["final_norm"] = rmsnorm_def(cfg.d_model)
    return defs


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        self.attn = attn_mod.Attention(cfg, dtype=dtype, device=device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        self.mlp = MLP(cfg, dtype=dtype, device=device)

    def forward(self, x, positions, cfg: ArchConfig, *, causal: bool, want_cache: bool):
        h, cache = attn_mod.attention_apply(
            self.attn, self.ln1(x), positions, cfg, causal=causal, want_cache=want_cache
        )
        x = x + h
        return x + self.mlp(self.ln2(x)), cache

    def decode(self, x, cache: dict, pos: torch.Tensor, cfg: ArchConfig):
        h, cache = attn_mod.attention_decode_step(self.attn, self.ln1(x), cache, pos, cfg)
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
        return x + h, cache

    def decode(self, x, cache: dict, pos: torch.Tensor, cfg: ArchConfig):
        h, cache = ssm_mod.ssm_decode_step(self.ssm, self.ln1(x), cache, cfg)
        return x + h, cache


class Transformer(nn.Module):
    """Uninitialised (``torch.empty``) parameters; see :func:`init_params`."""

    def __init__(self, cfg: ArchConfig, *, device="cuda"):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        dtype = DTYPES[cfg.dtype]
        self.cfg = cfg
        make_params(self, embed_defs(cfg), dtype=dtype, device=device)
        block = SSMBlock if block_kind(cfg) == "ssm" else Block
        self.layers = nn.ModuleList(
            block(cfg, dtype=dtype, device=device) for _ in range(cfg.n_layers)
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
        if name == "layers":
            for layer in module.layers:
                _walk_init(layer, _unstack_tree(d), gen)
        elif isinstance(d, ParamDef):
            init_(_target(module, name), d, gen)
        else:
            _walk_init(getattr(module, name), d, gen)


def _unstack_tree(defs):
    if isinstance(defs, ParamDef):
        return unstack_def(defs)
    return {k: _unstack_tree(v) for k, v in defs.items()}


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
    _walk_init(model, model_defs(cfg), gen)
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


def forward(model: Transformer, batch: dict, cfg: ArchConfig, *, want_cache: bool = False):
    """→ (hidden (B, L, D), caches | None); caches are stacked on a leading
    layer axis as in ``repro``: ``{'k', 'v'}: (n_layers, B, L, KH, Dh)`` for
    attention, ``{'state': (n_layers, B, H, N, P) float32, 'conv':
    (n_layers, B, 3, C)}`` for ssm."""
    tokens = batch["tokens"]
    x = embed_apply(model, tokens, cfg)
    B, L = tokens.shape
    positions = torch.arange(L, dtype=torch.int32, device=tokens.device).expand(B, L)
    causal = not cfg.is_encoder
    layer_caches = []
    for layer in model.layers:
        x, cache = _remat(layer, cfg)(x, positions, cfg, causal=causal, want_cache=want_cache)
        if want_cache:
            layer_caches.append(cache)
    x = model.final_norm(x)
    caches = None
    if want_cache:
        caches = {k: torch.stack([c[k] for c in layer_caches]) for k in layer_caches[0]}
    return x, caches


def loss_fn(model: Transformer, batch: dict, cfg: ArchConfig):
    """→ (total loss, {"ce_loss"}): mean next-token cross-entropy over
    ``batch["labels"]`` (masked by ``batch["mask"]`` when present), chunked
    over the sequence when ``cfg.logits_chunk`` is set."""
    x, _ = forward(model, batch, cfg)
    labels, mask = batch["labels"], batch.get("mask")
    if cfg.logits_chunk:
        loss = chunked_softmax_xent(x, labels, model, cfg, mask, chunk=cfg.logits_chunk)
    else:
        loss = softmax_xent(logits_apply(model, x, cfg), labels, mask)
    return loss, {"ce_loss": loss}


@torch.no_grad()
def prefill(model: Transformer, batch: dict, cfg: ArchConfig):
    """→ (last-token logits (B, 1, V), caches).  Only the final position's
    logits are computed."""
    x, caches = forward(model, batch, cfg, want_cache=True)
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
    for i, layer in enumerate(model.layers):
        layer_cache = {k: v[i] for k, v in caches.items()}
        x, _ = layer.decode(x, layer_cache, pos_b, cfg)
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

def cache_defs(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    check_supported(cfg)
    if block_kind(cfg) == "ssm":
        return stack_defs(ssm_mod.ssm_cache_defs(cfg, batch), cfg.n_layers)
    sh = attn_mod.kv_cache_shape(cfg, batch, max_seq)
    ax = ("batch", "kv_seq", "kv_heads", None)
    leaf = {"k": ParamDef(sh, ax, dtype=cfg.dtype), "v": ParamDef(sh, ax, dtype=cfg.dtype)}
    return stack_defs(leaf, cfg.n_layers)


def cache_layout(cfg: ArchConfig) -> Optional[dict]:
    """Per-leaf ``(batch_axis, seq_axis)`` of the stacked decode caches, the
    plumbing the paged serving tier needs; None for an ssm state (one
    vector per sequence, not per token) and for a ring-buffered (windowed)
    cache, whose slots fold positions modulo the window."""
    check_supported(cfg)
    if block_kind(cfg) == "ssm" or cfg.attn_window is not None:
        return None
    return {"k": (1, 2), "v": (1, 2)}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *, device="cuda") -> dict:
    device = resolve_device(device)
    return {
        name: torch.zeros(d.shape, dtype=DTYPES[d.dtype], device=device)
        for name, d in cache_defs(cfg, batch, max_seq).items()
    }
