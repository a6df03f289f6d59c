"""Mamba-2 SSD (state-space duality) layer — mamba2-130m [arXiv:2405.21060].

A port of ``repro.models.ssm``.  Prefill runs the chunked SSD algorithm
(``kernels/ssd/ops.py::ssd_chunked``): within chunks an attention-like
masked product, the CUDA kernel on the card; across chunks a short
recurrence over per-chunk states in plain torch.  Decode is the O(1) state
update in plain torch, writing the slot's ``state`` and ``conv`` caches
**in place**, as the attention decode writes its KV rows.

Shapes: x (B, L, D) → in_proj → z (gate), xh (B, L, H, P), B̄/C̄ (B, L, G, N),
dt (B, L, H); state (B, H, N, P).  The parameters keep ``repro``'s keys and
layouts (``in_proj (D, 2·d_in + 2·G·N + H)``, ``conv_w (4, C)``, ...).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd.ops import ssd_chunked
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import make_params
from repro_torch.models.param import ParamDef


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    return s, d_in, n_heads


def ssm_defs(cfg: ArchConfig) -> dict:
    s, d_in, H = _dims(cfg)
    D = cfg.d_model
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return {
        "in_proj": ParamDef((D, 2 * d_in + 2 * s.n_groups * s.d_state + H), ("embed", "ff")),
        "conv_w": ParamDef((4, conv_ch), (None, "ff")),
        "conv_b": ParamDef((conv_ch,), ("ff",), init="zeros"),
        "A_log": ParamDef((H,), (None,), init="ones"),
        "D": ParamDef((H,), (None,), init="ones"),
        "dt_bias": ParamDef((H,), (None,), init="const", scale=-4.0),
        "norm": ParamDef((d_in,), ("ff",), init="zeros"),
        "out_proj": ParamDef((d_in, D), ("ff", "embed")),
    }


def ssm_cache_defs(cfg: ArchConfig, batch: int) -> dict:
    """One layer's decode cache: ``state`` (B, H, N, P) in float32 and the
    conv window ``conv`` (B, 3, C) in the model dtype."""
    s, d_in, H = _dims(cfg)
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return {
        "state": ParamDef((batch, H, s.d_state, s.head_dim), ("batch", None, None, None), dtype="float32"),
        "conv": ParamDef((batch, 3, conv_ch), ("batch", None, "ff"), dtype=cfg.dtype),
    }


class SSM(nn.Module):
    """One SSD mixer.  Attributes are ``repro``'s keys; ``norm`` (the gated
    norm's offset-from-one scale) is a raw parameter, not an ``RMSNorm``:
    the gated norm is another function and does not go through the kernel."""

    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype, device):
        super().__init__()
        make_params(self, ssm_defs(cfg), dtype=dtype, device=device)


def _split_proj(m: SSM, x: torch.Tensor, cfg: ArchConfig):
    s, d_in, H = _dims(cfg)
    gn = s.n_groups * s.d_state
    zxbcdt = x @ m.in_proj
    return torch.split(zxbcdt, [d_in, d_in, gn, gn, H], dim=-1)  # z, xh, Bc, Cc, dt


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state=None):
    """Depthwise causal conv, width 4, via shifted products summed (as
    ``repro``; ``F.conv1d`` would go through cuDNN in TF32 on the card).
    u (B, L, C).  If ``state`` (B, 3, C) is given (decode), prepends it."""
    W = w.shape[0]
    if state is not None:
        u_full = torch.cat([state, u], dim=1)
    else:
        u_full = F.pad(u, (0, 0, W - 1, 0))
    L = u.shape[1]
    y = sum(u_full[:, i : i + L] * w[i] for i in range(W))
    new_state = u_full[:, -(W - 1):] if W > 1 else None
    return F.silu(y + b), new_state


def ssd_naive(xh, dt, A, Bc, Cc, initial_state=None):
    """O(L) sequential recurrence — test oracle for ``ssd_chunked``.
    xh (B, L, H, P), dt (B, L, H), A (H,), Bc/Cc (B, L, H, N)."""
    B, L, H, P = xh.shape
    N = Bc.shape[-1]
    s = (
        initial_state.float() if initial_state is not None
        else torch.zeros((B, H, N, P), dtype=torch.float32, device=xh.device)
    )
    ys = []
    for t in range(L):
        x_t, dt_t = xh[:, t].float(), dt[:, t].float()
        B_t, C_t = Bc[:, t].float(), Cc[:, t].float()
        a = torch.exp(dt_t * A)  # (B, H)
        upd = torch.einsum("bhn,bh,bhp->bhnp", B_t, dt_t, x_t)
        s = s * a[..., None, None] + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", C_t, s))
    return torch.stack(ys, dim=1), s


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    yf = y.float() * F.silu(z.float())
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return yf * torch.rsqrt(var + eps) * (1.0 + scale.float())


def ssm_apply(m: SSM, x: torch.Tensor, cfg: ArchConfig, *, want_cache: bool = False):
    """Prefill path.  x (B, L, D) → (y (B, L, D), cache | None)."""
    s, d_in, H = _dims(cfg)
    gn = s.n_groups * s.d_state
    z, xh, Bc, Cc, dt = _split_proj(m, x, cfg)
    conv_in = torch.cat([xh, Bc, Cc], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, m.conv_w, m.conv_b)
    xh, Bc, Cc = torch.split(conv_out, [d_in, gn, gn], dim=-1)
    B_, L, _ = x.shape
    xh = xh.reshape(B_, L, H, s.head_dim)
    # B/C stay (B, L, G, N): the kernel reads head h's group in place
    Bg = Bc.reshape(B_, L, s.n_groups, s.d_state)
    Cg = Cc.reshape(B_, L, s.n_groups, s.d_state)
    dt = F.softplus(dt.float() + m.dt_bias.float())
    A = -torch.exp(m.A_log.float())
    y, s_final = ssd_chunked(xh, dt, A, Bg, Cg, chunk=min(s.chunk_size, L))
    y = y + xh.float() * m.D.float()[:, None]
    y = y.reshape(B_, L, d_in)
    y = _gated_norm(y, z, m.norm, cfg.norm_eps).to(x.dtype)
    out = y @ m.out_proj
    if want_cache:
        return out, {"state": s_final, "conv": conv_state}
    return out, None


def ssm_decode_step(m: SSM, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    """x (B, 1, D); cache {'state': (B, H, N, P) float32, 'conv': (B, 3, C)},
    both **updated in place**.  → (out (B, 1, D), cache)."""
    s, d_in, H = _dims(cfg)
    gn = s.n_groups * s.d_state
    z, xh, Bc, Cc, dt = _split_proj(m, x, cfg)
    conv_in = torch.cat([xh, Bc, Cc], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, m.conv_w, m.conv_b, state=cache["conv"])
    xh, Bc, Cc = torch.split(conv_out, [d_in, gn, gn], dim=-1)
    B_, G = x.shape[0], s.n_groups
    # heads grouped as (G, H/G): each group's B/C row is broadcast, not copied
    xg = xh.reshape(B_, G, H // G, s.head_dim).float()
    Bg = Bc.reshape(B_, G, s.d_state).float()
    Cg = Cc.reshape(B_, G, s.d_state).float()
    dt = F.softplus(dt.float() + m.dt_bias.float())[:, 0]
    A = -torch.exp(m.A_log.float())
    a = torch.exp(dt * A)  # (B, H)
    upd = torch.einsum("bgn,bgk,bgkp->bgknp", Bg, dt.reshape(B_, G, H // G), xg)
    state = cache["state"]
    state.mul_(a[..., None, None]).add_(upd.reshape(state.shape))
    y = torch.einsum("bgn,bgknp->bgkp", Cg, state.reshape(B_, G, H // G, s.d_state, s.head_dim))
    y = y.reshape(B_, H, s.head_dim) + xg.reshape(B_, H, s.head_dim) * m.D.float()[:, None]
    y = y.reshape(B_, 1, d_in)
    y = _gated_norm(y, z, m.norm, cfg.norm_eps).to(x.dtype)
    out = y @ m.out_proj
    cache["conv"].copy_(conv_state)
    return out, cache
