"""Common layers: RMSNorm, rotary embeddings, gated MLPs, embedding, logits.

A port of ``repro.models.layers`` (the losses wait for the training slice).
Weights keep the JAX package's layouts; functions take the owning module.
RMSNorm goes through the CUDA kernel (``kernels/rmsnorm``) on the card and
its plain version on the CPU — ``repro`` computes it in jnp.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.param import DTYPES, ParamDef


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., D) normalised with f32 statistics, scaled by (1 + scale)."""
    return rmsnorm_ops.rmsnorm(x.contiguous(), scale, eps)


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
    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype, device):
        super().__init__()
        self.act = cfg.act
        make_params(self, mlp_defs(cfg.d_model, cfg.d_ff, cfg.act), dtype=dtype, device=device)

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
