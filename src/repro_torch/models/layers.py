"""Common layers: RMSNorm, rotary embeddings, gated MLPs, embedding, logits,
and the cross-entropy losses.

A port of ``repro.models.layers``.  Weights keep the JAX package's layouts;
functions take the owning module.  RMSNorm goes through the CUDA kernels
(``kernels/rmsnorm``, forward and, when autograd records, backward) on the
card and their plain versions on the CPU — ``repro`` computes it in jnp.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.param import DTYPES, ParamDef


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., D) normalised with f32 statistics, scaled by (1 + scale).
    Differentiable (the backward kernel) when autograd records."""
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return rmsnorm_ops.rmsnorm_train(x, scale, eps)
    return rmsnorm_ops.rmsnorm(x, scale, eps)


def rmsnorm_def(d: int) -> ParamDef:
    # stored as offset-from-one (gemma convention); init zeros → scale 1
    return ParamDef((d,), (None,), init="zeros")


class RMSNorm(nn.Module):
    """Holds the offset-from-one ``scale`` (JAX key: the norm's own name)."""

    def __init__(self, d: int, eps: float, *, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(d, dtype=dtype, device=device), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale, self.eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., L, n, head_dim); positions: (..., L) int."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (half,)
    angles = positions[..., None].float() * freqs  # (..., L, half)
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU / GELU)
# ---------------------------------------------------------------------------

def mlp_defs(d_model: int, d_ff: int, act: str) -> dict:
    if act in ("swiglu", "geglu"):
        return {
            "wi_gate": ParamDef((d_model, d_ff), ("embed", "ff")),
            "wi_up": ParamDef((d_model, d_ff), ("embed", "ff")),
            "wo": ParamDef((d_ff, d_model), ("ff", "embed")),
        }
    return {
        "wi": ParamDef((d_model, d_ff), ("embed", "ff")),
        "wo": ParamDef((d_ff, d_model), ("ff", "embed")),
    }


def make_params(module: nn.Module, defs: dict, *, dtype: torch.dtype, device) -> None:
    """Register one empty, frozen parameter per ParamDef leaf of ``defs``."""
    for name, d in defs.items():
        dt = DTYPES[d.dtype] if d.dtype else dtype
        module.register_parameter(
            name, nn.Parameter(torch.empty(d.shape, dtype=dt, device=device), requires_grad=False)
        )


class MLP(nn.Module):
    """The gated MLP of width ``d_ff`` (``cfg.d_ff`` unless given: a MoE's
    shared expert is wider)."""

    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype, device, d_ff: Optional[int] = None):
        super().__init__()
        self.act = cfg.act
        make_params(self, mlp_defs(cfg.d_model, d_ff or cfg.d_ff, cfg.act), dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act in ("swiglu", "geglu"):
            g = x @ self.wi_gate
            u = x @ self.wi_up
            g = F.silu(g) if self.act == "swiglu" else F.gelu(g, approximate="tanh")
            h = g * u
        else:
            h = F.gelu(x @ self.wi, approximate="tanh")
        return h @ self.wo


# ---------------------------------------------------------------------------
# Embedding + logits
# ---------------------------------------------------------------------------

def embed_defs(cfg: ArchConfig) -> dict:
    """Embedding (+ untied head) over the PADDED vocab."""
    v, d = cfg.padded_vocab, cfg.d_model
    out = {"embedding": ParamDef((v, d), ("vocab", "embed"), init="embed")}
    if not cfg.tie_embeddings:
        out["unembed"] = ParamDef((d, v), ("embed", "vocab"))
    return out


def embed_apply(model: nn.Module, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = model.embedding[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x.to(DTYPES[cfg.dtype])


def logits_apply(model: nn.Module, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if getattr(model, "unembed", None) is not None:
        logits = x @ model.unembed
    else:
        logits = x @ model.embedding.T
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    if cfg.padded_vocab != cfg.vocab:  # mask padding classes out of softmax
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy over (optionally masked) positions; fp32 math."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        m = mask.float()
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)


def _chunk_nll(xc, lc, mc, model, cfg):
    logits = logits_apply(model, xc, cfg).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return torch.sum((lse - gold) * mc)


def chunked_softmax_xent(x: torch.Tensor, labels: torch.Tensor, model: nn.Module, cfg: ArchConfig,
                         mask: Optional[torch.Tensor] = None, chunk: int = 1024) -> torch.Tensor:
    """Cross-entropy without materialising the full (T, vocab) logits: a
    loop over sequence chunks whose logits are recomputed in the backward
    (``torch.utils.checkpoint``, as ``repro`` wraps each chunk in
    ``jax.checkpoint``), so only one chunk's logits exist at a time."""
    B, L, D = x.shape
    n = L // chunk
    if n * chunk != L:
        raise ValueError(f"seq {L} not divisible by logits chunk {chunk}")
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    record = torch.is_grad_enabled()
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        xc, lc = x[:, sl], labels[:, sl]
        mc = (torch.ones(lc.shape, dtype=torch.float32, device=x.device) if mask is None
              else mask[:, sl].float())
        if record:
            t = checkpoint(_chunk_nll, xc, lc, mc, model, cfg, use_reentrant=False)
        else:
            t = _chunk_nll(xc, lc, mc, model, cfg)
        tot, cnt = tot + t, cnt + torch.sum(mc)
    return tot / torch.clamp(cnt, min=1.0)
