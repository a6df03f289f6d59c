"""The port's optimizers against a plain copy of their expressions, bit for
bit.  ``optim/optimizer.py`` writes each pass into scratch tensors (``out=``
and in-place ops) to save memory; that must not change a bit of the update.
``_adamw_plain`` / ``_adafactor_plain`` below are the same updates written
one allocating expression at a time, and every parameter and state tensor
must come out ``torch.equal`` to theirs over two steps: both optimizers, float32
and bfloat16 parameters, the nonfinite check accepting and rejecting, with
and without the clip factor.  The parameters cover every Adafactor branch:
an unstacked matrix and vector, a stacked vector leaf (factored over the
layers), stacked matrices and stacked (E, D, F) expert weights (factored
within each layer)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.optim import make_optimizer, param_leaves

LR = 3e-3


def _plain_store(dst, new, accept):
    new = new.to(dst.dtype)
    dst.copy_(new if accept is None else torch.where(accept, new, dst))


def _plain_grad(g, grad_scale):
    gf = g.float()
    return gf if grad_scale is None else gf * grad_scale


@torch.no_grad()
def _adamw_plain(grads, state, params, *, lr, step, accept=None, grad_scale=None,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    t = (step + 1).float()
    c1 = 1.0 - b1**t
    c2 = 1.0 - b2**t
    for n, p in params.items():
        gf = _plain_grad(grads[n], grad_scale)
        m, v = state["m"][n], state["v"][n]
        mf = m.float() * b1 + gf * (1 - b1)
        vf = v.float() * b2 + gf * gf * (1 - b2)
        pf = p.float()
        delta = (mf / c1) / (torch.sqrt(vf / c2) + eps) + weight_decay * pf
        _plain_store(p, pf - lr * delta, accept)
        _plain_store(m, mf, accept)
        _plain_store(v, vf, accept)


def _plain_denom(vr, vc, eps):
    mean_vr = torch.clamp(torch.mean(vr, dim=-1, keepdim=True)[..., None], min=eps)
    return torch.sqrt(vr[..., None] * vc[..., None, :] / mean_vr)


@torch.no_grad()
def _adafactor_plain(grads, state, params, *, lr, step, accept=None, grad_scale=None,
                     d=1.0, eps=1e-30, weight_decay=0.0):
    t = (step + 1).float()
    beta2 = 1.0 - t ** (-0.8)

    def new_param(p, upd, rms):
        upd = upd / torch.clamp(rms / d, min=1.0)
        pf = p.float()
        return pf - lr * (upd + weight_decay * pf)

    for leaf in param_leaves(params):
        s = state[leaf.path]
        ps = [params[n] for n in leaf.names]
        if not (leaf.stacked and "vr" in s and ps[0].dim() >= 2):
            stack = (lambda ts: torch.stack(ts)) if leaf.stacked else (lambda ts: ts[0])  # noqa: E731
            gf = stack([_plain_grad(grads[n], grad_scale) for n in leaf.names])
            g2 = gf * gf + eps
            if "vr" in s:
                vr = beta2 * s["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
                vc = beta2 * s["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
                upd = gf / torch.clamp(_plain_denom(vr, vc, eps), min=eps)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta2 * s["v"] + (1 - beta2) * g2
                upd = gf / torch.sqrt(torch.clamp(v, min=eps))
                new_s = {"v": v}
            rms = torch.sqrt(torch.mean(torch.square(upd)) + eps)
            new_p = new_param(stack([p.float() for p in ps]) if leaf.stacked else ps[0], upd, rms)
            for i, p in enumerate(ps):
                _plain_store(p, new_p[i] if leaf.stacked else new_p, accept)
        else:
            new_s = {"vr": torch.empty_like(s["vr"]), "vc": torch.empty_like(s["vc"])}
            sumsq = torch.zeros((), dtype=torch.float32)
            for i, n in enumerate(leaf.names):
                gf = _plain_grad(grads[n], grad_scale)
                g2 = gf * gf + eps
                new_s["vr"][i] = beta2 * s["vr"][i] + (1 - beta2) * torch.mean(g2, dim=-1)
                new_s["vc"][i] = beta2 * s["vc"][i] + (1 - beta2) * torch.mean(g2, dim=-2)
                upd = gf / torch.clamp(_plain_denom(new_s["vr"][i], new_s["vc"][i], eps), min=eps)
                sumsq = sumsq + torch.sum(torch.square(upd))
            rms = torch.sqrt(sumsq / sum(p.numel() for p in ps) + eps)
            for i, n in enumerate(leaf.names):
                gf = _plain_grad(grads[n], grad_scale)
                upd = gf / torch.clamp(_plain_denom(new_s["vr"][i], new_s["vc"][i], eps), min=eps)
                _plain_store(ps[i], new_param(ps[i], upd, rms), accept)
        for k, v in new_s.items():
            _plain_store(s[k], v, accept)


SHAPES = {"embedding": (24, 16), "final_norm.scale": (16,)}
for _i in range(2):
    SHAPES.update({f"layers.{_i}.ln1.scale": (16,), f"layers.{_i}.attn.wq": (16, 12),
                   f"layers.{_i}.moe.wi_gate": (4, 16, 8)})


def _tensors(rng, dtype, scale=1.0) -> dict:
    return {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * scale).to(dtype)
            for n, s in SHAPES.items()}


def _clone(t):
    return {k: _clone(v) for k, v in t.items()} if isinstance(t, dict) else t.clone()


@pytest.mark.parametrize("clip", [False, True], ids=["no_clip", "clip"])
@pytest.mark.parametrize("accept", [None, True, False], ids=["no_check", "accept", "reject"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_matches_its_plain_expressions_bit_for_bit(kind, dtype, accept, clip):
    rng = np.random.default_rng(7)
    params = _tensors(rng, dtype)
    init, update = make_optimizer(kind)
    plain = {"adamw": _adamw_plain, "adafactor": _adafactor_plain}[kind]
    state = init(params)
    p_plain, s_plain = _clone(params), _clone(state)
    acc = None if accept is None else torch.tensor(accept)
    for step in range(2):
        grads = _tensors(rng, dtype, scale=0.1)
        scale = torch.tensor(0.37, dtype=torch.float32) if clip else None
        lr, t = torch.tensor(LR, dtype=torch.float32), torch.tensor(step, dtype=torch.int32)
        update(grads, state, params, lr, t, accept=acc, grad_scale=scale)
        plain(grads, s_plain, p_plain, lr=lr, step=t, accept=acc, grad_scale=scale)
    for n in params:
        assert torch.equal(params[n], p_plain[n]), n
        if accept is False:
            assert torch.equal(params[n], _tensors(np.random.default_rng(7), dtype)[n]), n
    flat = lambda t, pre="": [x for k, v in t.items() for x in (flat(v, pre + k + "/") if isinstance(v, dict) else [(pre + k, v)])]  # noqa: E731
    got, want = dict(flat(state)), dict(flat(s_plain))
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
