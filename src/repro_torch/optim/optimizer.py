"""Optimizers: AdamW (opt-state dtype knob) and factored Adafactor.

A port of ``repro.optim.optimizer``.  Updates are computed in float32 from
tensors on the parameters' device, leaf by leaf, and written **in place**
(``repro`` returns new trees): the new value of every parameter and state
tensor is ``torch.where(accept, new, old)``, so a step whose gradients are
not finite leaves every bit as it was (the branchless rollback of the train
step) and no second copy of the model is ever held.

Parameters are the port's ``dict(model.named_parameters())``.  ``repro``
stacks each layer parameter on a leading layer axis, and Adafactor's
factoring and its update clipping by RMS are taken over that stacked leaf;
:func:`param_leaves` groups the port's per-layer tensors into the same
leaves, so both packages compute the same update.  A leaf whose per-layer
tensors have two or more dims is factored per layer (only the RMS spans the
layers: it is taken in a first pass and applied in a second); a stacked
leaf of 1-D tensors (the norms) is stacked, being small.

A hybrid model stacks its layers in ``repro`` by super-block position
(``layers/rec_0/...`` over the super-blocks, ``tail_0/...`` unstacked):
``layout`` (``models.leaf_layout(cfg)``, also the model's ``leaf_layout``)
carries that map into :func:`leaf_path`, :func:`param_leaves` and the
optimizers.  Expert weights are (E, D, F) a layer: factored over their last
two dims, per expert and layer, as ``repro`` factors its (L, E, D, F) leaf.

On a ``model`` mesh axis (``shards``: the model's ``Shard`` of each
parameter, ``group``: the axis' process group) each rank updates its part
of every parameter, as ``repro``'s ``train_state_shardings`` lays the state
out: AdamW's ``m`` / ``v`` are the local parts (elementwise, nothing to
reduce); Adafactor's ``vr`` / ``vc`` / ``v`` stay whole and replicated, so
a row or column mean over a sharded dimension is a sum over ``model``, a
kept sharded dimension is gathered (each rank's part placed in zeros and
summed over ``model``: exact), ``_factored_denom``'s ``mean(vr)`` is taken
over the whole ``vr`` and the RMS clip's mean over the whole leaf sums its
squares over ``model``.  Every rank then holds the same state bits.
:func:`global_norm` sums the squares of sharded gradients over ``model``
and counts the replicated ones once.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import math

import torch

from repro_torch.dist.collectives import model_sum_
from repro_torch.models.param import DTYPES


class TrainState(NamedTuple):
    step: torch.Tensor  # int32 scalar on the model's device
    params: Any  # the Transformer, trainable
    opt: Any  # optimizer state (dicts of tensors)


class Leaf(NamedTuple):
    """One leaf of ``repro``'s parameter tree in terms of the port's names."""

    path: str  # '/'-joined key path in repro's tree, e.g. "layers/attn/wq"
    names: tuple[str, ...]  # the port's parameter names, one per layer when stacked
    stacked: bool


def leaf_path(name: str, layout=None) -> tuple[str, Optional[int]]:
    """Port parameter name → (repro tree path, index on the leaf's stacked
    layer axis or None).  An ``RMSNorm`` holds its offset under ``scale``;
    ``repro`` keys it by the norm's own name.  ``layout`` (None: layer i is
    index i of ``layers/...``) gives each layer's (path prefix, index)."""
    parts = name.split(".")
    if parts[-1] == "scale":
        parts = parts[:-1]
    if parts[0] == "layers":
        i = int(parts[1])
        prefix, index = ("layers", i) if layout is None else layout[i]
        return "/".join([prefix] + parts[2:]), index
    return "/".join(parts), None


def param_leaves(names, layout=None) -> list[Leaf]:
    """Group parameter names (in order) into ``repro``'s leaves."""
    groups: dict[str, list[tuple[Optional[int], str]]] = {}
    for n in names:
        path, layer = leaf_path(n, layout)
        groups.setdefault(path, []).append((layer, n))
    out = []
    for path, members in groups.items():
        stacked = members[0][0] is not None
        ordered = sorted(members) if stacked else members
        out.append(Leaf(path, tuple(n for _, n in ordered), stacked))
    return out


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

def global_norm(tensors, *, sharded=None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor (float32).  ``torch.sum``,
    not ``torch.linalg.vector_norm``: on the CPU the latter's float32
    reduction is off by ~1% at 1e8 elements (the size of an embedding's
    gradient), where ``sum`` reduces pairwise.  With ``group`` (a ``model``
    axis), the tensors flagged by ``sharded`` (one bool each) are parts of
    their gradients: their squares are summed over ``group``, the others'
    counted once."""
    sq = [torch.sum(torch.square(t.float())) for t in tensors]
    if group is None:
        return torch.sqrt(torch.stack(sq).sum())
    flags = list(sharded)
    parts = [q for q, f in zip(sq, flags) if f]
    whole = [q for q, f in zip(sq, flags) if not f]
    total = model_sum_(torch.stack(parts).sum().reshape(1), group)[0] if parts else sq[0].new_zeros(())
    return torch.sqrt(total + torch.stack(whole).sum() if whole else total)


def clip_by_global_norm(grads: dict, max_norm: float):
    """→ (clipped copies, norm), as ``repro``'s."""
    norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, norm


@torch.no_grad()
def _store(dst: torch.Tensor, new: torch.Tensor, accept: Optional[torch.Tensor]) -> None:
    """dst ← new where ``accept`` holds, else dst (bit for bit).  ``new`` is
    a scratch tensor of the caller's: the select may overwrite it."""
    new = new.to(dst.dtype)
    dst.copy_(new if accept is None else torch.where(accept, new, dst, out=new))


def _grad(g: torch.Tensor, grad_scale) -> torch.Tensor:
    gf = g.float()
    return gf if grad_scale is None else gf * grad_scale


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params: dict, dtype: str = "float32") -> dict:
    dt = DTYPES[dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    return {"m": {n: zeros(p) for n, p in params.items()},
            "v": {n: zeros(p) for n, p in params.items()}}


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params: dict, *, lr, step, accept=None,
                 grad_scale=None, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """In place: each parameter and its ``m`` / ``v`` (elementwise, so one
    tensor at a time).  ``grad_scale`` multiplies every gradient first (the
    clip factor)."""
    t = (step + 1).float()
    c1 = 1.0 - b1**t
    c2 = 1.0 - b2**t
    for n, p in params.items():
        gf = _grad(grads[n], grad_scale)  # may be the gradient itself: read only
        m, v = state["m"][n], state["v"][n]
        # repro's expressions, each pass written into a scratch tensor (one
        # allocation saved a pass; the same operations, so the same bits)
        tmp = gf * (1 - b1)
        mf = (m.float() * b1).add_(tmp)  # m·b1 + g·(1 - b1)
        torch.mul(gf, gf, out=tmp)
        vf = (v.float() * b2).add_(tmp.mul_(1 - b2))  # v·b2 + g·g·(1 - b2)
        pf = p.float()
        torch.div(vf, c2, out=tmp).sqrt_().add_(eps)
        delta = torch.div(mf, c1).div_(tmp)
        delta.add_(torch.mul(pf, weight_decay, out=tmp))  # (m / c1) / (sqrt(v / c2) + eps) + wd·p
        _store(p, torch.sub(pf, delta.mul_(lr), out=delta), accept)  # p - lr·delta
        _store(m, mf, accept)
        _store(v, vf, accept)
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (factored second moments for ≥2-D leaves)
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _leaf_shape(leaf: Leaf, params: dict, shards=None) -> tuple[int, ...]:
    n = leaf.names[0]
    shape = tuple(params[n].shape) if shards is None else tuple(shards[n].full)
    return ((len(leaf.names),) + shape) if leaf.stacked else shape


def adafactor_init(params: dict, layout=None, shards=None) -> dict:
    """{leaf path: {"vr", "vc"} or {"v"}}, float32, shaped as ``repro``'s
    (the layer axis first for stacked leaves); whole (``shards``' full
    shapes) on a ``model`` axis."""
    out = {}
    for leaf in param_leaves(params, layout):
        shape = _leaf_shape(leaf, params, shards)
        dev = params[leaf.names[0]].device
        z = lambda s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
        if _factored(shape):
            out[leaf.path] = {"vr": z(shape[:-1]), "vc": z(shape[:-2] + shape[-1:])}
        else:
            out[leaf.path] = {"v": z(shape)}
    return out


def _factored_denom(vr: torch.Tensor, vc: torch.Tensor, eps: float, index=None) -> torch.Tensor:
    """sqrt(vr·vcᵀ / mean(vr)); with ``index``, only the part at ``index``
    of that whole product (the mean still over the whole ``vr``)."""
    mean_vr = torch.clamp(torch.mean(vr, dim=-1, keepdim=True)[..., None], min=eps)
    if index is not None:
        lead = index[:-2]
        vr, vc, mean_vr = vr[lead + index[-2:-1]], vc[lead + index[-1:]], mean_vr[lead]
    return (vr[..., None] * vc[..., None, :]).div_(mean_vr).sqrt_()


def _factored_update(gf: torch.Tensor, vr: torch.Tensor, vc: torch.Tensor, eps: float,
                     index=None) -> torch.Tensor:
    """g / max(sqrt(vr·vcᵀ / mean(vr)), eps), in one new tensor; ``gf`` is
    the part at ``index`` when one is given."""
    den = _factored_denom(vr, vc, eps, index).clamp_(min=eps)
    return torch.div(gf, den, out=den)


# A leaf sharded over ``model`` is reduced through its ``part``: (spec,
# index, full) of this rank's part of the whole leaf.  ``part`` None (and
# ``group`` None) is a whole leaf, and every reduction below is then the
# plain one.

def _at(t: torch.Tensor, part) -> torch.Tensor:
    return t if part is None else t[part[1]]


def _place(x: torch.Tensor, part, group) -> torch.Tensor:
    """The whole tensor of which every rank of ``group`` holds ``x`` at its
    index: the parts placed in zeros and summed (exact)."""
    if part is None:
        return x
    out = x.new_zeros(part[2])
    out[part[1]] = x
    return model_sum_(out, group)


def _mean(x: torch.Tensor, dim: int, part, group) -> torch.Tensor:
    """``mean(x, dim)`` of the whole tensor whose part ``x`` is, replicated
    on every rank."""
    if part is None:
        return torch.mean(x, dim=dim)
    spec, index, full = part
    dim %= x.dim()
    if spec[dim] is not None:  # reduced over a sharded dim: a sum over the ranks
        return model_sum_(torch.sum(x, dim=dim), group).div_(full[dim])
    drop = lambda t: t[:dim] + t[dim + 1:]  # noqa: E731
    out = torch.mean(x, dim=dim)
    return out if all(e is None for e in drop(spec)) else _place(out, tuple(map(drop, part)), group)


def _sq_mean(upd: torch.Tensor, out: torch.Tensor, part, group) -> torch.Tensor:
    """mean(upd²) over the whole leaf (``out``: scratch for the squares)."""
    if part is None:
        return torch.mean(torch.square(upd, out=out))
    total = model_sum_(torch.sum(torch.square(upd, out=out)).reshape(1), group)[0]
    return total / math.prod(part[2])


@torch.no_grad()
def adafactor_update(grads: dict, state: dict, params: dict, *, lr, step, accept=None,
                     grad_scale=None, d: float = 1.0, eps: float = 1e-30,
                     weight_decay: float = 0.0, layout=None, shards=None, group=None):
    """In place, leaf by leaf (see the module docstring for the layer axis
    and for ``shards`` / ``group``, a ``model`` mesh axis)."""
    t = (step + 1).float()
    beta2 = 1.0 - t ** (-0.8)

    def new_param(p, upd, rms, scratch):
        """p - lr·(upd / max(rms / d, 1) + wd·p), written into ``scratch``
        (``upd`` is scaled in place)."""
        upd.div_(torch.clamp(rms / d, min=1.0))
        pf = p.float()
        out = torch.mul(pf, weight_decay, out=scratch).add_(upd).mul_(lr)
        return torch.sub(pf, out, out=out)

    for leaf in param_leaves(params, layout):
        s = state[leaf.path]
        ps = [params[n] for n in leaf.names]
        sh = None if shards is None else shards[leaf.names[0]]
        part, grp = ((tuple(sh.spec), sh.index, tuple(sh.full)), group) if sh is not None and sh.sharded \
            else (None, None)
        per_part = leaf.stacked and "vr" in s and ps[0].dim() >= 2
        if not per_part:  # one tensor (stacked when the leaf is): repro's arithmetic
            stack = (lambda ts: torch.stack(ts)) if leaf.stacked else (lambda ts: ts[0])  # noqa: E731
            if leaf.stacked and part is not None:  # the layer axis leads, whole
                part = ((None,) + part[0], (slice(None),) + part[1], (len(ps),) + part[2])
            gf = stack([_grad(grads[n], grad_scale) for n in leaf.names])
            g2 = (gf * gf).add_(eps)
            if "vr" in s:
                vr = beta2 * s["vr"] + (1 - beta2) * _mean(g2, -1, part, grp)
                vc = beta2 * s["vc"] + (1 - beta2) * _mean(g2, -2, part, grp)
                upd = _factored_update(gf, vr, vc, eps, None if part is None else part[1])
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta2 * _at(s["v"], part) + (1 - beta2) * g2
                upd = torch.div(gf, torch.sqrt(torch.clamp(v, min=eps)))
                new_s = {"v": _place(v, part, grp)}
            rms = torch.sqrt(_sq_mean(upd, g2, part, grp) + eps)
            new_p = new_param(stack([p.float() for p in ps]) if leaf.stacked else ps[0], upd, rms, g2)
            for i, p in enumerate(ps):
                _store(p, new_p[i] if leaf.stacked else new_p, accept)
        else:  # factored within each layer; only the RMS spans the layers
            index = None if part is None else part[1]
            new_s = {"vr": torch.empty_like(s["vr"]), "vc": torch.empty_like(s["vc"])}
            sumsq = torch.zeros((), dtype=torch.float32, device=ps[0].device)
            for i, n in enumerate(leaf.names):
                gf = _grad(grads[n], grad_scale)
                g2 = (gf * gf).add_(eps)
                new_s["vr"][i] = beta2 * s["vr"][i] + (1 - beta2) * _mean(g2, -1, part, grp)
                new_s["vc"][i] = beta2 * s["vc"][i] + (1 - beta2) * _mean(g2, -2, part, grp)
                upd = _factored_update(gf, new_s["vr"][i], new_s["vc"][i], eps, index)
                sumsq = sumsq + torch.sum(torch.square(upd, out=g2))
                del g2, upd
            numel = len(ps) * math.prod(ps[0].shape if part is None else part[2])
            sumsq = sumsq if grp is None else model_sum_(sumsq.reshape(1), grp)[0]
            rms = torch.sqrt(sumsq / numel + eps)
            for i, n in enumerate(leaf.names):
                gf = _grad(grads[n], grad_scale)
                upd = _factored_update(gf, new_s["vr"][i], new_s["vc"][i], eps, index)
                _store(ps[i], new_param(ps[i], upd, rms, torch.empty_like(upd)), accept)
        for k, v in new_s.items():
            _store(s[k], v, accept)
    return params, state


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------

def make_optimizer(kind: str, opt_state_dtype: str = "float32", layout=None, shards=None, group=None):
    """→ (init_fn(params), update_fn(grads, opt, params, lr, step, accept,
    grad_scale)); both take ``dict(model.named_parameters())``.  ``layout``
    is the model's ``leaf_layout`` (Adafactor groups by it); ``shards`` /
    ``group`` its ``Shard``s and ``model`` axis group on a ``model`` mesh
    axis (Adafactor's whole state; AdamW's is elementwise)."""
    if kind == "adamw":
        return (
            lambda params: adamw_init(params, opt_state_dtype),
            lambda g, s, p, lr, step, accept=None, grad_scale=None: adamw_update(
                g, s, p, lr=lr, step=step, accept=accept, grad_scale=grad_scale),
        )
    if kind == "adafactor":
        return (
            lambda params: adafactor_init(params, layout, shards),
            lambda g, s, p, lr, step, accept=None, grad_scale=None: adafactor_update(
                g, s, p, lr=lr, step=step, accept=accept, grad_scale=grad_scale, layout=layout,
                shards=shards, group=group),
        )
    raise ValueError(f"unknown optimizer {kind!r}")
