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
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

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


def leaf_path(name: str) -> tuple[str, Optional[int]]:
    """Port parameter name → (repro tree path, layer index or None).  An
    ``RMSNorm`` holds its offset under ``scale``; ``repro`` keys it by the
    norm's own name."""
    parts = name.split(".")
    if parts[-1] == "scale":
        parts = parts[:-1]
    if parts[0] == "layers":
        return "/".join(["layers"] + parts[2:]), int(parts[1])
    return "/".join(parts), None


def param_leaves(names) -> list[Leaf]:
    """Group parameter names (in order) into ``repro``'s leaves."""
    groups: dict[str, list[tuple[Optional[int], str]]] = {}
    for n in names:
        path, layer = leaf_path(n)
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

def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor (float32).  ``torch.sum``,
    not ``torch.linalg.vector_norm``: on the CPU the latter's float32
    reduction is off by ~1% at 1e8 elements (the size of an embedding's
    gradient), where ``sum`` reduces pairwise."""
    sq = [torch.sum(torch.square(t.float())) for t in tensors]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(grads: dict, max_norm: float):
    """→ (clipped copies, norm), as ``repro``'s."""
    norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, norm


@torch.no_grad()
def _store(dst: torch.Tensor, new: torch.Tensor, accept: Optional[torch.Tensor]) -> None:
    """dst ← new where ``accept`` holds, else dst (bit for bit)."""
    new = new.to(dst.dtype)
    dst.copy_(new if accept is None else torch.where(accept, new, dst))


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
        gf = _grad(grads[n], grad_scale)
        m, v = state["m"][n], state["v"][n]
        mf = m.float() * b1 + gf * (1 - b1)
        vf = v.float() * b2 + gf * gf * (1 - b2)
        pf = p.float()
        delta = (mf / c1) / (torch.sqrt(vf / c2) + eps) + weight_decay * pf
        _store(p, pf - lr * delta, accept)
        _store(m, mf, accept)
        _store(v, vf, accept)
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (factored second moments for ≥2-D leaves)
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _leaf_shape(leaf: Leaf, params: dict) -> tuple[int, ...]:
    shape = tuple(params[leaf.names[0]].shape)
    return ((len(leaf.names),) + shape) if leaf.stacked else shape


def adafactor_init(params: dict) -> dict:
    """{leaf path: {"vr", "vc"} or {"v"}}, float32, shaped as ``repro``'s
    (the layer axis first for stacked leaves)."""
    out = {}
    for leaf in param_leaves(params):
        shape = _leaf_shape(leaf, params)
        dev = params[leaf.names[0]].device
        z = lambda s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
        if _factored(shape):
            out[leaf.path] = {"vr": z(shape[:-1]), "vc": z(shape[:-2] + shape[-1:])}
        else:
            out[leaf.path] = {"v": z(shape)}
    return out


def _factored_denom(vr: torch.Tensor, vc: torch.Tensor, eps: float) -> torch.Tensor:
    mean_vr = torch.clamp(torch.mean(vr, dim=-1, keepdim=True)[..., None], min=eps)
    return torch.sqrt(vr[..., None] * vc[..., None, :] / mean_vr)


@torch.no_grad()
def adafactor_update(grads: dict, state: dict, params: dict, *, lr, step, accept=None,
                     grad_scale=None, d: float = 1.0, eps: float = 1e-30,
                     weight_decay: float = 0.0):
    """In place, leaf by leaf (see the module docstring for the layer axis)."""
    t = (step + 1).float()
    beta2 = 1.0 - t ** (-0.8)

    def new_param(p, upd, rms):
        upd = upd / torch.clamp(rms / d, min=1.0)
        pf = p.float()
        return pf - lr * (upd + weight_decay * pf)

    for leaf in param_leaves(params):
        s = state[leaf.path]
        ps = [params[n] for n in leaf.names]
        per_part = leaf.stacked and "vr" in s and ps[0].dim() >= 2
        if not per_part:  # one tensor (stacked when the leaf is): repro's arithmetic
            stack = (lambda ts: torch.stack(ts)) if leaf.stacked else (lambda ts: ts[0])  # noqa: E731
            gf = stack([_grad(grads[n], grad_scale) for n in leaf.names])
            g2 = gf * gf + eps
            if "vr" in s:
                vr = beta2 * s["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
                vc = beta2 * s["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
                upd = gf / torch.clamp(_factored_denom(vr, vc, eps), min=eps)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta2 * s["v"] + (1 - beta2) * g2
                upd = gf / torch.sqrt(torch.clamp(v, min=eps))
                new_s = {"v": v}
            rms = torch.sqrt(torch.mean(torch.square(upd)) + eps)
            new_p = new_param(stack([p.float() for p in ps]) if leaf.stacked else ps[0], upd, rms)
            for i, p in enumerate(ps):
                _store(p, new_p[i] if leaf.stacked else new_p, accept)
        else:  # factored within each layer; only the RMS spans the layers
            new_s = {"vr": torch.empty_like(s["vr"]), "vc": torch.empty_like(s["vc"])}
            sumsq = torch.zeros((), dtype=torch.float32, device=ps[0].device)
            for i, n in enumerate(leaf.names):
                gf = _grad(grads[n], grad_scale)
                g2 = gf * gf + eps
                new_s["vr"][i] = beta2 * s["vr"][i] + (1 - beta2) * torch.mean(g2, dim=-1)
                new_s["vc"][i] = beta2 * s["vc"][i] + (1 - beta2) * torch.mean(g2, dim=-2)
                del g2
                upd = gf / torch.clamp(_factored_denom(new_s["vr"][i], new_s["vc"][i], eps), min=eps)
                sumsq = sumsq + torch.sum(torch.square(upd))
            numel = sum(p.numel() for p in ps)
            rms = torch.sqrt(sumsq / numel + eps)
            for i, n in enumerate(leaf.names):
                gf = _grad(grads[n], grad_scale)
                upd = gf / torch.clamp(_factored_denom(new_s["vr"][i], new_s["vc"][i], eps), min=eps)
                _store(ps[i], new_param(ps[i], upd, rms), accept)
        for k, v in new_s.items():
            _store(s[k], v, accept)
    return params, state


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------

def make_optimizer(kind: str, opt_state_dtype: str = "float32"):
    """→ (init_fn(params), update_fn(grads, opt, params, lr, step, accept,
    grad_scale)); both take ``dict(model.named_parameters())``."""
    if kind == "adamw":
        return (
            lambda params: adamw_init(params, opt_state_dtype),
            lambda g, s, p, lr, step, accept=None, grad_scale=None: adamw_update(
                g, s, p, lr=lr, step=step, accept=accept, grad_scale=grad_scale),
        )
    if kind == "adafactor":
        return (
            adafactor_init,
            lambda g, s, p, lr, step, accept=None, grad_scale=None: adafactor_update(
                g, s, p, lr=lr, step=step, accept=accept, grad_scale=grad_scale),
        )
    raise ValueError(f"unknown optimizer {kind!r}")
