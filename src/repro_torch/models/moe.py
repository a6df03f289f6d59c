"""Mixture-of-Experts layer — qwen3-moe-235b-a22b, llama4-scout.

A port of ``repro.models.moe`` on one card (no expert parallelism).  The
router runs in float32 (its parameter is float32) and returns the aux
losses (load balance and router z-loss) for the trainer.  Two dispatches:

* ``einsum`` (the configs' default) — GShard capacity dispatch with a
  per-group capacity C; the k = 0 choice of every token claims capacity
  before any k = 1 choice.  Tokens beyond an expert's capacity are
  dropped.  Dispatch and combine both go through each choice's slot (see
  :func:`_einsum_moe`): a token's output does not depend on the others in
  its group while none is dropped, so a decode step's tokens do not depend
  on the batch.
* ``scatter`` — sort-based: the (token, choice) pairs sorted stably by
  expert (``torch.argsort(stable=True)``, as ``jnp.argsort`` is), added
  into per-expert capacity buffers (``index_add``), the expert FFNs run on
  the packed (E, C, D) buffer and the results are added back per token.
  On the card ``index_add`` adds in no fixed order, and the combine gives
  each token ``top_k`` adds, so its float sums (in the model dtype) can
  differ in the last bits from run to run; the einsum dispatch has no such
  adds.

``repro`` computes both in jnp outside any Pallas kernel, so the port does
it with torch ops.  ``torch.topk`` and ``jax.lax.top_k`` order ties
differently; router probabilities from continuous inputs do not tie.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import MLP, make_params, mlp_defs
from repro_torch.models.param import ParamDef


def moe_defs(cfg: ArchConfig) -> dict:
    m = cfg.moe
    D, Fe, E = cfg.d_model, m.d_ff_expert, m.n_experts
    defs = {
        "router": ParamDef((D, E), ("embed", None), dtype="float32"),
        "wi_gate": ParamDef((E, D, Fe), ("experts", "embed", "expert_ff")),
        "wi_up": ParamDef((E, D, Fe), ("experts", "embed", "expert_ff")),
        "wo": ParamDef((E, Fe, D), ("experts", "expert_ff", "embed")),
    }
    if m.n_shared_experts:
        defs["shared"] = mlp_defs(D, Fe * m.n_shared_experts, cfg.act)
    return defs


class MoE(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype, device):
        super().__init__()
        defs = moe_defs(cfg)
        defs.pop("shared", None)
        make_params(self, defs, dtype=dtype, device=device)
        m = cfg.moe
        if m.n_shared_experts:
            self.shared = MLP(cfg, dtype=dtype, device=device,
                              d_ff=m.d_ff_expert * m.n_shared_experts)


def capacity(tokens_per_group: int, cfg: ArchConfig) -> int:
    """Slots per expert: capacity_factor · tokens · top_k / E, rounded up to
    a multiple of 8, at least 8."""
    m = cfg.moe
    c = int(m.capacity_factor * tokens_per_group * m.top_k / m.n_experts)
    return max(8, -(-c // 8) * 8)


def _router(p: MoE, xt: torch.Tensor, cfg: ArchConfig):
    """xt (..., D) → (top-k probs renormalised, top-k experts, aux losses)."""
    m = cfg.moe
    logits = xt.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, m.top_k, dim=-1)
    top_p = top_p / torch.clamp(torch.sum(top_p, dim=-1, keepdim=True), min=1e-9)
    E = m.n_experts
    lead = tuple(range(probs.ndim - 1))
    me = torch.mean(probs, dim=lead)  # mean probability per expert
    ce = torch.mean(F.one_hot(top_i[..., 0], E).float(), dim=lead)
    balance = E * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return top_p, top_i, {"moe_balance": balance, "moe_zloss": z}


def _expert_ffn(p: MoE, t: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """t (..., E, C, D) → (..., E, C, D): each expert's gated MLP."""
    g = torch.einsum("...ecd,edf->...ecf", t, p.wi_gate)
    u = torch.einsum("...ecd,edf->...ecf", t, p.wi_up)
    g = F.silu(g) if cfg.act == "swiglu" else F.gelu(g, approximate="tanh")
    return torch.einsum("...ecf,efd->...ecd", g * u, p.wo)


def _einsum_moe(p: MoE, x_grp: torch.Tensor, cfg: ArchConfig):
    """x_grp (G, S, D): G token groups, capacity per group.  Each choice's
    slot is ``repro``'s (a cumulative count of the expert's earlier
    choices).  The dispatch writes each kept choice's token into its slot,
    which is what ``repro``'s one-hot (G, S, E, C) einsum gives exactly,
    each slot holding one token.  The combine gathers each token's top_k
    slot outputs and adds them in choice order, where ``repro`` contracts a
    (G, S, E, C) combine tensor over (E, C): the same sum, but an einsum
    would add a token's terms at positions that move with its capacity
    slot, which the other tokens' choices set, so a token's output would
    depend on its batch."""
    m = cfg.moe
    G, S, D = x_grp.shape
    E, K = m.n_experts, m.top_k
    C = capacity(S, cfg)
    top_p, top_i, aux = _router(p, x_grp, cfg)  # (G, S, K)
    dev = x_grp.device
    acc_counts = torch.zeros((G, E), dtype=torch.float32, device=dev)
    slot_of, kept = [], []
    for k in range(K):
        ohk = F.one_hot(top_i[..., k], E).float()  # (G, S, E)
        pos = torch.cumsum(ohk, dim=1) - ohk + acc_counts[:, None, :]
        acc_counts = acc_counts + torch.sum(ohk, dim=1)
        pos_of = torch.sum(pos * ohk, dim=-1)  # (G, S)
        slot_of.append(top_i[..., k] * C + torch.clamp(pos_of, max=C - 1).long())
        kept.append(pos_of < C)
    idx = torch.stack(slot_of, dim=-1)  # (G, S, K): each choice's slot
    keep = torch.stack(kept, dim=-1)
    rows = torch.arange(G, device=dev)[:, None, None]
    # a dropped choice writes to a spare row E·C, cut off after
    ein = x_grp.new_zeros((G, E * C + 1, D)).index_put(
        (rows, torch.where(keep, idx, E * C)), x_grp[:, :, None, :].expand(G, S, K, D))
    h = _expert_ffn(p, ein[:, :E * C].reshape(G, E, C, D), cfg).reshape(G, E * C, D)
    w = top_p * keep  # a dropped choice adds nothing
    picked = h[rows, idx].float()  # (G, S, K, D)
    y = torch.sum(picked * w[..., None], dim=2)
    return y.to(x_grp.dtype), aux


def _scatter_moe(p: MoE, xt: torch.Tensor, cfg: ArchConfig):
    """xt (T, D) flat tokens."""
    m = cfg.moe
    T, D = xt.shape
    E, K = m.n_experts, m.top_k
    C = capacity(T, cfg)
    top_p, top_i, aux = _router(p, xt, cfg)  # (T, K)
    flat_e = top_i.reshape(-1)
    flat_g = top_p.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    token_of = order // K
    counts = torch.bincount(se, minlength=E)
    offsets = torch.cumsum(counts, dim=0) - counts
    slot = torch.arange(T * K, device=xt.device) - offsets[se]
    keep = slot < C
    dest = se * C + torch.clamp(slot, 0, C - 1)
    gathered = xt[token_of] * keep[:, None].to(xt.dtype)
    buf = torch.zeros((E * C, D), dtype=xt.dtype, device=xt.device).index_add(0, dest, gathered)
    h = _expert_ffn(p, buf.reshape(E, C, D), cfg).reshape(E * C, D)
    contrib = h[dest] * (flat_g[order] * keep)[:, None].to(h.dtype)
    y = torch.zeros((T, D), dtype=xt.dtype, device=xt.device).index_add(0, token_of, contrib.to(xt.dtype))
    return y, aux


def moe_apply(p: MoE, x: torch.Tensor, cfg: ArchConfig):
    """x (B, L, D) → (y, aux).  The einsum dispatch groups tokens so the
    capacity is local (at most 4096 tokens a group); the scatter dispatch
    takes them flat."""
    m = cfg.moe
    B, L, D = x.shape
    T = B * L
    if m.dispatch == "einsum":
        g_tokens = min(4096, T)
        y, aux = _einsum_moe(p, x.reshape(T // g_tokens, g_tokens, D), cfg)
    elif m.dispatch == "scatter":
        y, aux = _scatter_moe(p, x.reshape(T, D), cfg)
    else:
        raise ValueError(f"unknown moe dispatch {m.dispatch!r}")
    y = y.reshape(B, L, D)
    if m.n_shared_experts:
        y = y + p.shared(x)
    return y, aux
