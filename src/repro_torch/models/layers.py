"""Common layers: RMSNorm, rotary embeddings, gated MLPs, embedding, logits,
and the cross-entropy losses.

A port of ``repro.models.layers``.  Weights keep the JAX package's layouts;
functions take the owning module.  RMSNorm goes through the CUDA kernels
(``kernels/rmsnorm``, forward and, when autograd records, backward) on the
card and their plain versions on the CPU — ``repro`` computes it in jnp.

On a mesh with a ``model`` axis (``dist.sharding.model_axis``) the layers
are tensor-parallel where ``safe_spec`` shards their weights, as GSPMD runs
``repro``'s: the MLP's ``wi_*`` by columns (``ff``) and ``wo`` by rows, its
output summed over ``model``; the embedding and the logits by ``vocab``
(rows outside a rank's shard embed to zero and the sum over ``model`` fills
them; each rank's logits are its own classes, masked and soft-capped by
their global index) and the cross-entropy over those shards: the row max
and the sum of exponentials are reduced over ``model`` and the label's
logit comes from the rank that holds it, so no rank holds the full logits.
Serving reads them the same way: :func:`greedy_tokens` takes the argmax
over the whole vocabulary from each rank's (max, global index), and
:func:`gather_logits` puts a row together where a caller wants it whole.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.collectives import copy_to_model, model_all_gather, model_max_, reduce_from_model
from repro_torch.dist.sharding import current_mesh, model_axis, safe_spec
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.param import DTYPES, ParamDef, local_shape


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
    """Register one empty, frozen parameter per ParamDef leaf of ``defs``,
    at this rank's part of its shape under the active mesh (``safe_spec``;
    the whole shape off-mesh)."""
    mesh = current_mesh()
    for name, d in defs.items():
        dt = DTYPES[d.dtype] if d.dtype else dtype
        shape = d.shape if mesh is None else local_shape(d.shape, safe_spec(d.shape, d.axes, mesh=mesh), mesh)
        module.register_parameter(
            name, nn.Parameter(torch.empty(shape, dtype=dt, device=device), requires_grad=False)
        )


def sharded_axis(d: ParamDef, dim: int):
    """The active mesh's ``model`` axis (``ModelAxis``) when ``safe_spec``
    shards dimension ``dim`` of ``d`` over it, else None."""
    tp = model_axis()
    return tp if tp is not None and safe_spec(d.shape, d.axes)[dim] is not None else None


class MLP(nn.Module):
    """The gated MLP of width ``d_ff`` (``cfg.d_ff`` unless given: a MoE's
    shared expert is wider); tensor-parallel over ``ff`` when the mesh's
    ``model`` axis shards it (``self.tp``)."""

    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype, device, d_ff: Optional[int] = None):
        super().__init__()
        self.act = cfg.act
        defs = mlp_defs(cfg.d_model, d_ff or cfg.d_ff, cfg.act)
        make_params(self, defs, dtype=dtype, device=device)
        self.tp = sharded_axis(defs["wo"], 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = copy_to_model(x, self.tp.group)
        if self.act in ("swiglu", "geglu"):
            g = x @ self.wi_gate
            u = x @ self.wi_up
            g = F.silu(g) if self.act == "swiglu" else F.gelu(g, approximate="tanh")
            h = g * u
        else:
            h = F.gelu(x @ self.wi, approximate="tanh")
        out = h @ self.wo
        return out if self.tp is None else reduce_from_model(out, self.tp.group)


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
    tp = getattr(model, "vocab_tp", None)
    if tp is None:
        x = model.embedding[tokens]
    else:  # this rank's rows; the others' tokens embed to zero, the sum fills them
        v = model.embedding.shape[0]
        local = tokens.long() - tp.rank * v
        inside = (local >= 0) & (local < v)
        rows = model.embedding[local.clamp(0, v - 1)]
        x = reduce_from_model(torch.where(inside[..., None], rows, torch.zeros_like(rows)), tp.group)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x.to(DTYPES[cfg.dtype])


def logits_apply(model: nn.Module, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Logits over the padded vocab, or over this rank's shard of it when
    the ``model`` axis shards ``vocab`` (``model.vocab_tp``)."""
    tp = getattr(model, "vocab_tp", None)
    if tp is not None:
        x = copy_to_model(x, tp.group)
    if getattr(model, "unembed", None) is not None:
        logits = x @ model.unembed
    else:
        logits = x @ model.embedding.T
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    if cfg.padded_vocab != cfg.vocab:  # mask padding classes out of softmax
        v = logits.shape[-1]
        lo = 0 if tp is None else tp.rank * v  # global class index of column 0
        pad = torch.arange(lo, lo + v, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def gather_logits(model: nn.Module, logits: torch.Tensor) -> torch.Tensor:
    """Logits (..., V) whole from each rank's vocab part (..., V/m) (one
    all-gather over ``model``); as they are off a vocab-sharded axis."""
    tp = getattr(model, "vocab_tp", None)
    if tp is None:
        return logits
    got = model_all_gather(logits, tp.group)  # (m, ..., V/m), the ranks' classes in order
    return torch.cat(list(got.unbind(0)), dim=-1)


def greedy_tokens(model: nn.Module, logits: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax(logits, -1)`` as int32 over the whole vocabulary, the
    first index of a tie: with vocab-sharded logits each rank's (max, global
    index of its first max) is all-gathered (one collective, float64: exact
    for both) and the first rank holding the largest max wins, whose classes
    come first."""
    tp = getattr(model, "vocab_tp", None)
    if tp is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    mx, idx = logits.max(dim=-1)  # the first index of the rank's max
    idx = idx + tp.rank * logits.shape[-1]
    got = model_all_gather(torch.stack([mx.double(), idx.double()], dim=-1), tp.group)  # (m, ..., 2)
    best = torch.argmax(got[..., 0], dim=0, keepdim=True)  # the first rank with the largest max
    return torch.gather(got[..., 1], 0, best)[0].to(torch.int32)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def vocab_parallel_nll(lg: torch.Tensor, labels: torch.Tensor, tp) -> torch.Tensor:
    """Per-position cross-entropy of float32 logits ``lg`` that hold this
    rank's classes of the ``model`` axis ``tp``: the row max (untracked: a
    shift) and the sum of exponentials reduced over ``model``, the label's
    logit from the rank whose classes hold it."""
    v = lg.shape[-1]
    mx = model_max_(lg.detach().amax(dim=-1).contiguous(), tp.group)
    lse = torch.log(reduce_from_model(torch.exp(lg - mx[..., None]).sum(dim=-1), tp.group)) + mx
    local = labels.long() - tp.rank * v
    inside = (local >= 0) & (local < v)
    gold = torch.gather(lg, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    return lse - reduce_from_model(torch.where(inside, gold, torch.zeros_like(gold)), tp.group)


def _nll(lg: torch.Tensor, labels: torch.Tensor, tp) -> torch.Tensor:
    if tp is not None:
        return vocab_parallel_nll(lg, labels, tp)
    lse = torch.logsumexp(lg, dim=-1)
    return lse - torch.gather(lg, -1, labels.long()[..., None])[..., 0]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, tp=None) -> torch.Tensor:
    """Mean cross-entropy over (optionally masked) positions; fp32 math.
    With ``tp`` (a ``ModelAxis``) ``logits`` are this rank's vocab shard
    (:func:`vocab_parallel_nll`)."""
    nll = _nll(logits.float(), labels, tp)
    if mask is not None:
        m = mask.float()
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)


def _chunk_nll(xc, lc, mc, model, cfg):
    logits = logits_apply(model, xc, cfg).float()
    return torch.sum(_nll(logits, lc, getattr(model, "vocab_tp", None)) * mc)


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
