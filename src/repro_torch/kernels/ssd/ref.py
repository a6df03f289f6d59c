"""Plain PyTorch versions of the SSD intra-chunk kernel and its backward.

The port of ``repro.kernels.ssd.ref.ssd_chunk_ref``, batched over every
leading dimension instead of one chunk at a time.  For each chunk it computes,
in float32 as the reference does,

* ``y``     — the causal decay-weighted attention-like part
  ``y_i = Σ_{j ≤ i} (C_i · B_j) · exp(cum_i − cum_j) · dt_j · x_j``;
* ``state`` — the end-of-chunk state ``Σ_j exp(cum_last − cum_j)·dt_j·B_j x_jᵀ``,

which the inter-chunk recurrence then combines.  For i < j the decay
``exp(cum_i − cum_j)`` may overflow to inf, so the difference is masked to
−inf before it is exponentiated: the forward never sees inf, and neither
does autograd (``where(causal, exp(diff), 0)`` sends a zero cotangent into
exp of an inf entry, and 0·inf = NaN in the gradient of ``cum``).

:func:`ssd_chunk_bwd_ref` is the backward written out as formulas, the
yardstick of ``csrc/ssd_bwd.cu``.  Used for CPU tensors and by the tests;
the card runs ``csrc/ssd.cu`` and ``csrc/ssd_bwd.cu``.
"""
from __future__ import annotations

import torch


def _grouped(x, dt, cum, B, C):
    """With 5 dims (b, H, ...) and G < H groups on B/C's head axis: x, dt,
    cum as (b, G, H/G, ...) against B/C as (b, G, 1, ...)."""
    if x.ndim == 5 and B.shape[1] != x.shape[1]:
        G = B.shape[1]
        x, dt, cum = (t.unflatten(1, (G, x.shape[1] // G)) for t in (x, dt, cum))
        return x, dt, cum, B.unsqueeze(2), C.unsqueeze(2), True
    return x, dt, cum, B, C, False


def _decay(cumf: torch.Tensor) -> torch.Tensor:
    """exp(cum_i − cum_j) on i ≥ j, 0 above the diagonal (exp of −inf)."""
    cs = cumf.shape[-1]
    ii = torch.arange(cs, device=cumf.device)
    causal = ii[:, None] >= ii[None, :]
    diff = cumf[..., :, None] - cumf[..., None, :]
    return torch.exp(torch.where(causal, diff, torch.full((), -torch.inf, device=cumf.device)))


def ssd_chunk_ref(
    x: torch.Tensor,    # (..., nc, cs, P)
    dt: torch.Tensor,   # (..., nc, cs)
    cum: torch.Tensor,  # (..., nc, cs) cumulative log-decay within each chunk
    B: torch.Tensor,    # (..., nc, cs, N); with 5 dims the head axis may hold G groups
    C: torch.Tensor,    # (..., nc, cs, N)
):
    """→ (y (..., nc, cs, P), state (..., nc, N, P)), both float32.  With 5
    dims (b, H, nc, cs, ·), B and C may hold G | H groups on the head axis:
    head h reads group h // (H // G), broadcast rather than copied."""
    x, dt, cum, B, C, grouped = _grouped(x, dt, cum, B, C)
    xf, dtf, cumf = x.float(), dt.float(), cum.float()
    Bf, Cf = B.float(), C.float()
    scores = (Cf @ Bf.transpose(-1, -2)) * _decay(cumf) * dtf[..., None, :]
    y = scores @ xf  # (..., cs, P)
    decay_end = torch.exp(cumf[..., -1:] - cumf)
    state = (Bf * (decay_end * dtf)[..., None]).transpose(-1, -2) @ xf  # (..., N, P)
    if grouped:
        y, state = y.flatten(1, 2), state.flatten(1, 2)
    return y, state


def ssd_chunk_bwd_ref(x, dt, cum, B, C, dy, dS):
    """The vector-Jacobian product of :func:`ssd_chunk_ref` for the
    cotangents ``dy`` (..., nc, cs, P) of y and ``dS`` (..., nc, N, P) of
    the state, as explicit formulas in float32.  With s_ij = C_i·B_j,
    L_ij = exp(cum_i − cum_j) (i ≥ j), W_ij = s_ij L_ij dt_j,
    e_j = exp(cum_last − cum_j) and u_j = dS x_j:

    * dW = dy xᵀ on i ≥ j;
    * dx_j = Σ_{i≥j} W_ij dy_i + e_j dt_j dSᵀ B_j;
    * dC_i = Σ_{j≤i} dW_ij L_ij dt_j B_j;
    * dB_j = Σ_{i≥j} dW_ij L_ij dt_j C_i + e_j dt_j u_j;
    * ddt_j = Σ_{i≥j} dW_ij s_ij L_ij + e_j B_j·u_j;
    * with M = dW ∘ W: dcum = rowsum(M) − colsum(M) − e_j dt_j B_j·u_j,
      plus Σ_j e_j dt_j B_j·u_j on the chunk's last row.

    → (dx, ddt, dcum, dB, dC) in the inputs' dtypes; with G < H groups on
    B/C's head axis, dB and dC sum the group's heads (the VJP of the
    broadcast)."""
    dtypes = [t.dtype for t in (x, dt, cum, B, C)]
    x, dt, cum, B, C, grouped = _grouped(x, dt, cum, B, C)
    if grouped:
        G = B.shape[1]
        dy, dS = (t.unflatten(1, (G, t.shape[1] // G)) for t in (dy, dS))
    xf, dtf, cumf, Bf, Cf = (t.float() for t in (x, dt, cum, B, C))
    dy, dS = dy.float(), dS.float()
    Lm = _decay(cumf)
    s = Cf @ Bf.transpose(-1, -2)
    W = s * Lm * dtf[..., None, :]
    dW = dy @ xf.transpose(-1, -2)  # every use below is weighted by L: 0 above the diagonal
    Gm = dW * Lm * dtf[..., None, :]  # d s_ij
    M = dW * W
    e = torch.exp(cumf[..., -1:] - cumf)
    u = xf @ dS.transpose(-1, -2)  # (..., cs, N): u_j = dS x_j
    Bu = (Bf * u).sum(-1)  # B_j · u_j
    q = e * dtf * Bu
    dx = W.transpose(-1, -2) @ dy + (e * dtf)[..., None] * (Bf @ dS)
    dC = Gm @ Bf
    dB = Gm.transpose(-1, -2) @ Cf + (e * dtf)[..., None] * u
    ddt = (dW * s * Lm).sum(-2) + e * Bu
    dcum = M.sum(-1) - M.sum(-2) - q
    dcum[..., -1] += q.sum(-1)
    if grouped:
        dx, ddt, dcum = (t.flatten(1, 2) for t in (dx, ddt, dcum))
        dB, dC = dB.sum(2), dC.sum(2)
    return tuple(g.to(dtype) for g, dtype in zip((dx, ddt, dcum, dB, dC), dtypes))
