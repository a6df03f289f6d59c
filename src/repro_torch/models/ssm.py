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

On a ``model`` mesh axis of m > 1 each leaf is this rank's part under
``safe_spec`` (``ff``: ``in_proj``'s columns, ``conv_w`` / ``conv_b``'s
channels, ``norm`` and ``out_proj``'s rows where m divides them; ``A_log``,
``D`` and ``dt_bias`` replicated).  The stored splits do not follow the
segments z | xh | B | C | dt, so the block runs on *channels*: where m
divides d_in (``SSM.tp``) rank r owns the channels ``[r·d_in/m, (r+1)·d_in/m)``
of z, xh, y, the gated norm and ``out_proj``'s rows, and every group's B
and C.  Its heads are cut into sub-heads of P' = gcd(d_in/m, P) channels
(P' = P where m divides the heads), each with its head's dt, A and D, so
each rank runs the SSD kernel on whole sub-heads of its own (:func:`_plan`).
The sharded ``in_proj`` / ``conv_w`` / ``conv_b`` are all-gathered whole
(weights: D × (2·d_in + 2·G·N + H), far fewer bytes than the activations of
a training sequence), their gradients reduce-scattered
(``dist.collectives.gather_from_model``); each rank projects only its
columns.  The gated norm's mean square over d_in is one sum over ``model``
(forward and backward), ``out_proj`` is row-parallel (its output summed
over ``model``).  A prefill's cache is ``repro``'s: ``state`` whole on
every rank (the sub-heads' states all-gathered), ``conv`` the rank's
channels of the stored split.  Decode keeps the state whole on every rank
and updates all of it there from whole activations (the rank's projection
columns and conv channels all-gathered: a token's worth), so the ranks'
states stay the same bits; the norm and ``out_proj`` run on its channels.
Where m does not divide d_in each rank runs the whole block (the gathered
weights' gradients then each rank's own).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.collectives import copy_to_model, gather_from_model, model_all_gather, reduce_from_model
from repro_torch.dist.sharding import model_axis
from repro_torch.kernels.ssd.ops import ssd_chunked
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import make_params, sharded_axis
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


#: the leaves a ``model`` axis may shard, with their sharded dimension
_SPLIT_LEAVES = {"in_proj": 1, "conv_w": 1, "conv_b": 0}


class SSM(nn.Module):
    """One SSD mixer.  Attributes are ``repro``'s keys; ``norm`` (the gated
    norm's offset-from-one scale) is a raw parameter, not an ``RMSNorm``:
    the gated norm is another function and does not go through the kernel.
    ``axis`` is the mesh's ``model`` axis (None off it), ``tp`` that axis
    when it splits the channels (module docstring), ``split`` the leaves
    it shards among ``in_proj``, ``conv_w`` and ``conv_b``."""

    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype, device):
        super().__init__()
        defs = ssm_defs(cfg)
        make_params(self, defs, dtype=dtype, device=device)
        self.axis = model_axis()
        self.tp = sharded_axis(defs["out_proj"], 0)
        self.split = frozenset(n for n, dim in _SPLIT_LEAVES.items() if sharded_axis(defs[n], dim) is not None)


def partial_grad_names(m: SSM) -> tuple[str, ...]:
    """Replicated leaves (names under ``m``) used on this rank's channels
    alone: each rank's gradient is a part of theirs."""
    if m.tp is None:
        return ()
    return ("A_log", "D", "dt_bias") + tuple(n for n in _SPLIT_LEAVES if n not in m.split)


class _Plan(NamedTuple):
    """This rank's channels and sub-heads (module docstring): channels
    ``[ch0, ch0 + c)``, heads ``[h0, h1)`` cut into sub-heads of ``Pp``
    channels, ``parent`` the index in ``[h0, h1)`` of each local sub-head's
    head (None: the heads themselves), ``groups`` the B/C groups they read
    (a slice, or one group a sub-head)."""

    ch0: int
    c: int
    h0: int
    h1: int
    Pp: int
    parent: Optional[list]
    groups: object


def _local_groups(gidx: list):
    """The groups of the local sub-heads as ``ssd_chunked`` takes them: a
    slice where they are consecutive groups of as many sub-heads each, else
    the list (one group a sub-head)."""
    g0, n = gidx[0], gidx[-1] - gidx[0] + 1
    per = len(gidx) // n
    if per * n == len(gidx) and all(g - g0 == j // per for j, g in enumerate(gidx)):
        return slice(g0, g0 + n)
    return gidx


def _plan(m: SSM, cfg: ArchConfig) -> _Plan:
    s, d_in, H = _dims(cfg)
    P, G = s.head_dim, s.n_groups
    if m.tp is None:
        return _Plan(0, d_in, 0, H, P, None, slice(0, G))
    c = d_in // m.tp.size
    ch0 = m.tp.rank * c
    Pp = math.gcd(c, P)
    k = P // Pp
    subs = range(ch0 // Pp, (ch0 + c) // Pp)
    heads = [j // k for j in subs]
    h0, h1 = heads[0], heads[-1] + 1
    parent = None if k == 1 else [h - h0 for h in heads]
    return _Plan(ch0, c, h0, h1, Pp, parent, _local_groups([h // (H // G) for h in heads]))


def _whole(m: SSM, name: str) -> torch.Tensor:
    """Leaf ``name`` whole: gathered over ``model`` where it is sharded."""
    w = getattr(m, name)
    if name not in m.split:
        return w
    return gather_from_model(w, m.axis.group, _SPLIT_LEAVES[name], partial=m.tp is not None)


def _cols(w: torch.Tensor, ranges: list) -> torch.Tensor:
    """The columns ``[a, b)`` of each of ``ranges`` of ``w``, in order (``w``
    itself where they are all of it)."""
    if len(ranges) == 1 or all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1)):
        a, b = ranges[0][0], ranges[-1][1]
        return w if (a, b) == (0, w.shape[-1]) else w[..., a:b]
    return torch.cat([w[..., a:b] for a, b in ranges], dim=-1)


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


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps: float, tp=None) -> torch.Tensor:
    """The gated RMS norm over the last dim; with ``tp`` (a ``ModelAxis``)
    ``y`` / ``z`` / ``scale`` are this rank's channels and the mean square
    is summed over ``model`` (its gradient too: each rank's channels give a
    part of it)."""
    yf = y.float() * F.silu(z.float())
    if tp is None:
        var = torch.mean(yf * yf, dim=-1, keepdim=True)
    else:
        ss = torch.sum(yf * yf, dim=-1, keepdim=True)
        var = copy_to_model(reduce_from_model(ss, tp.group), tp.group) / (yf.shape[-1] * tp.size)
    return yf * torch.rsqrt(var + eps) * (1.0 + scale.float())


def _pick(t: torch.Tensor, parent: Optional[list]) -> torch.Tensor:
    """A per-head vector's entries of each local sub-head (last dim)."""
    return t if parent is None else t[..., torch.tensor(parent, device=t.device)]


def _whole_state(s_final: torch.Tensor, pl: _Plan, m: SSM, cfg: ArchConfig) -> torch.Tensor:
    """Every rank's sub-heads' final states (B, ·, N, P') → the whole state
    (B, H, N, P), the same bits on every rank."""
    if m.tp is None:
        return s_final
    s, _, H = _dims(cfg)
    got = model_all_gather(s_final.contiguous(), m.tp.group)  # (m, B, n, N, P')
    Bsz, N, Pp = got.shape[1], got.shape[3], got.shape[4]
    k = s.head_dim // Pp
    subs = got.permute(1, 0, 2, 3, 4).reshape(Bsz, H, k, N, Pp)
    return subs.permute(0, 1, 3, 2, 4).reshape(Bsz, H, N, s.head_dim)


def _stored_conv(state: torch.Tensor, pl: _Plan, m: SSM, cfg: ArchConfig) -> torch.Tensor:
    """The conv window of this rank's channels and B/C (B, 3, c + 2·G·N) →
    its part of the cache's ``conv`` (B, 3, C): the channels all-gathered,
    then the stored split's part (the whole window where it is not split)."""
    if m.axis is None:
        return state
    if m.tp is not None:
        xs = model_all_gather(state[..., :pl.c].contiguous(), m.tp.group)  # (m, B, 3, c)
        state = torch.cat(list(xs.unbind(0)) + [state[..., pl.c:]], dim=-1)
    if "conv_w" not in m.split:
        return state
    n = state.shape[-1] // m.axis.size
    return state[..., m.axis.rank * n:(m.axis.rank + 1) * n].contiguous()


def ssm_apply(m: SSM, x: torch.Tensor, cfg: ArchConfig, *, want_cache: bool = False):
    """Prefill path.  x (B, L, D) → (y (B, L, D), cache | None); on a
    ``model`` axis tensor-parallel over this rank's channels (module
    docstring)."""
    s, d_in, H = _dims(cfg)
    gn = s.n_groups * s.d_state
    pl = _plan(m, cfg)
    if m.tp is not None:
        x = copy_to_model(x, m.tp.group)
    z_cols, x_cols = (pl.ch0, pl.ch0 + pl.c), (d_in + pl.ch0, d_in + pl.ch0 + pl.c)
    w_in = _cols(_whole(m, "in_proj"), [z_cols, x_cols, (2 * d_in, 2 * d_in + 2 * gn),
                                        (2 * d_in + 2 * gn + pl.h0, 2 * d_in + 2 * gn + pl.h1)])
    z, xh, bc, dt = torch.split(x @ w_in, [pl.c, pl.c, 2 * gn, pl.h1 - pl.h0], dim=-1)
    conv_sel = [(pl.ch0, pl.ch0 + pl.c), (d_in, d_in + 2 * gn)]
    conv_out, conv_state = _causal_conv(torch.cat([xh, bc], dim=-1), _cols(_whole(m, "conv_w"), conv_sel),
                                        _cols(_whole(m, "conv_b"), conv_sel))
    xh, Bc, Cc = torch.split(conv_out, [pl.c, gn, gn], dim=-1)
    B_, L, _ = x.shape
    xh = xh.reshape(B_, L, pl.c // pl.Pp, pl.Pp)
    # B/C stay (B, L, G, N): the kernel reads head h's group in place
    Bg = Bc.reshape(B_, L, s.n_groups, s.d_state)[:, :, pl.groups]
    Cg = Cc.reshape(B_, L, s.n_groups, s.d_state)[:, :, pl.groups]
    heads = slice(pl.h0, pl.h1)
    dt = _pick(F.softplus(dt.float() + m.dt_bias[heads].float()), pl.parent)
    A = _pick(-torch.exp(m.A_log[heads].float()), pl.parent)
    y, s_final = ssd_chunked(xh, dt, A, Bg, Cg, chunk=min(s.chunk_size, L))
    y = y + xh.float() * _pick(m.D[heads].float(), pl.parent)[:, None]
    y = y.reshape(B_, L, pl.c)
    y = _gated_norm(y, z, m.norm, cfg.norm_eps, m.tp).to(x.dtype)
    out = y @ m.out_proj
    if m.tp is not None:
        out = reduce_from_model(out, m.tp.group)
    if want_cache:
        return out, {"state": _whole_state(s_final, pl, m, cfg), "conv": _stored_conv(conv_state, pl, m, cfg)}
    return out, None


def _gather_last(t: torch.Tensor, m: SSM) -> torch.Tensor:
    """Every rank's ``t`` put together along the last dim (untracked)."""
    return torch.cat(list(model_all_gather(t.contiguous(), m.axis.group).unbind(0)), dim=-1)


def ssm_decode_step(m: SSM, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    """x (B, 1, D); cache {'state': (B, H, N, P) float32, 'conv': (B, 3, C)},
    both **updated in place**.  → (out (B, 1, D), cache).  On a ``model``
    axis the state is whole and updated whole on every rank, from the whole
    projection and conv output (each all-gathered from the ranks' parts);
    ``conv`` is this rank's part, the norm and ``out_proj`` its channels."""
    s, d_in, H = _dims(cfg)
    gn = s.n_groups * s.d_state
    zxbcdt = x @ m.in_proj
    if "in_proj" in m.split:
        zxbcdt = _gather_last(zxbcdt, m)
    z, xh, Bc, Cc, dt = torch.split(zxbcdt, [d_in, d_in, gn, gn, H], dim=-1)
    conv_in = torch.cat([xh, Bc, Cc], dim=-1)
    if "conv_w" in m.split:  # this rank's channels of the stored split, then all of them
        n = conv_in.shape[-1] // m.axis.size
        part, conv_state = _causal_conv(conv_in[..., m.axis.rank * n:(m.axis.rank + 1) * n], m.conv_w, m.conv_b,
                                        state=cache["conv"])
        conv_out = _gather_last(part, m)
    else:
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
    if m.tp is None:
        y = _gated_norm(y, z, m.norm, cfg.norm_eps)
    else:  # the whole mean square, this rank's channels
        ch = slice(m.tp.rank * (d_in // m.tp.size), (m.tp.rank + 1) * (d_in // m.tp.size))
        y = _gated_norm(y, z, torch.zeros((), device=y.device), cfg.norm_eps)[..., ch] * (1.0 + m.norm.float())
    out = y.to(x.dtype) @ m.out_proj
    if m.tp is not None:
        out = reduce_from_model(out, m.tp.group)
    cache["conv"].copy_(conv_state)
    return out, cache
