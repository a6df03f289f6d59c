"""RG-LRU recurrent block — recurrentgemma-9b / Griffin [arXiv:2402.19427].

A port of ``repro.models.rglru``.  In-proj to two branches — a GeLU gate
branch and a (causal conv → RG-LRU) branch — multiplied and projected out.
The recurrence per channel::

    r_t = σ(W_a u_t + b_a)          (recurrence gate)
    i_t = σ(W_x u_t + b_x)          (input gate)
    log a_t = −c · softplus(Λ) · r_t          (c = 8)
    h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ u_t)

The gates' two W × W products run in float32, as in ``repro``.  Prefill /
train computes the recurrence with :func:`rglru_scan`, a log-depth doubling
scan over shifted views (``repro`` uses ``jax.lax.associative_scan`` with
the same pair combine); decode is the single-step update, writing the
slot's ``h`` and ``conv`` caches **in place**.  ``repro`` runs the block in
jnp outside any Pallas kernel, so the port runs it in torch ops; only its
norms (in the enclosing block) go through a kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import make_params
from repro_torch.models.param import ParamDef

_C = 8.0


def rglru_defs(cfg: ArchConfig) -> dict:
    h = cfg.hybrid
    D = cfg.d_model
    W = h.lru_width or D
    return {
        "in_x": ParamDef((D, W), ("embed", "ff")),
        "in_gate": ParamDef((D, W), ("embed", "ff")),
        "conv_w": ParamDef((h.conv_width, W), (None, "ff")),
        "conv_b": ParamDef((W,), ("ff",), init="zeros"),
        "w_a": ParamDef((W, W), (None, "ff")),
        "b_a": ParamDef((W,), ("ff",), init="zeros"),
        "w_x": ParamDef((W, W), (None, "ff")),
        "b_x": ParamDef((W,), ("ff",), init="zeros"),
        "Lambda": ParamDef((W,), ("ff",), init="const", scale=4.0),
        "out_proj": ParamDef((W, D), ("ff", "embed")),
    }


def rglru_cache_defs(cfg: ArchConfig, batch: int) -> dict:
    """One layer's decode cache: ``h`` (B, W) float32 and the conv window
    ``conv`` (B, conv_width − 1, W) in the model dtype."""
    W = cfg.hybrid.lru_width or cfg.d_model
    return {
        "h": ParamDef((batch, W), ("batch", "ff"), dtype="float32"),
        "conv": ParamDef((batch, cfg.hybrid.conv_width - 1, W), ("batch", None, "ff"), dtype=cfg.dtype),
    }


class RGLRU(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype, device):
        super().__init__()
        make_params(self, rglru_defs(cfg), dtype=dtype, device=device)


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state=None):
    """Depthwise causal conv as shifted products summed (no activation).
    u (B, L, W); ``state`` (B, Wd − 1, W) is prepended when given (decode).
    → (y, the last Wd − 1 inputs)."""
    Wd = w.shape[0]
    u_full = torch.cat([state, u], dim=1) if state is not None else F.pad(u, (0, 0, Wd - 1, 0))
    L = u.shape[1]
    y = sum(u_full[:, i : i + L] * w[i] for i in range(Wd))
    return y + b, u_full[:, -(Wd - 1):]


def _gates(p: RGLRU, u: torch.Tensor):
    """u (B, L, W) → (a, gated input), both float32."""
    uf = u.float()
    r = torch.sigmoid(uf @ p.w_a.float() + p.b_a.float())
    i = torch.sigmoid(uf @ p.w_x.float() + p.b_x.float())
    a = torch.exp(-_C * F.softplus(p.Lambda.float()) * r)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * (i * uf)


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0=None) -> torch.Tensor:
    """h_t = a_t h_{t−1} + b_t over axis 1 (h_{−1} = ``h0`` or 0), by
    ⌈log₂ L⌉ rounds of the pair combine (a, b) ← (a·a⁻, a·b⁻ + b), where
    a⁻, b⁻ are the pairs ``d`` steps earlier (d = 1, 2, 4, ...)."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    L, d = a.shape[1], 1
    while d < L:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < L:  # the last round's a is not read
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_apply(p: RGLRU, x: torch.Tensor, cfg: ArchConfig, *, want_cache: bool = False):
    """Griffin recurrent block; x (B, L, D) → (y (B, L, D), cache | None)."""
    gate = F.gelu(x @ p.in_gate, approximate="tanh")
    u, conv_state = _causal_conv(x @ p.in_x, p.conv_w, p.conv_b)
    a, b = _gates(p, u)
    h = rglru_scan(a, b)
    out = (h.to(x.dtype) * gate) @ p.out_proj
    if want_cache:
        return out, {"h": h[:, -1], "conv": conv_state}
    return out, None


def rglru_decode_step(p: RGLRU, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    """x (B, 1, D); cache {'h': (B, W) float32, 'conv': (B, Wd − 1, W)},
    both **updated in place**.  → (out (B, 1, D), cache)."""
    gate = F.gelu(x @ p.in_gate, approximate="tanh")
    u, conv_state = _causal_conv(x @ p.in_x, p.conv_w, p.conv_b, state=cache["conv"])
    a, b = _gates(p, u)
    h = cache["h"]
    h.mul_(a[:, 0]).add_(b[:, 0])
    out = (h[:, None].to(x.dtype) * gate) @ p.out_proj
    cache["conv"].copy_(conv_state)
    return out, cache
