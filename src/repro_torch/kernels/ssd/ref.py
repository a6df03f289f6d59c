"""Plain PyTorch version of the SSD intra-chunk kernel.

The port of ``repro.kernels.ssd.ref.ssd_chunk_ref``, batched over every
leading dimension instead of one chunk at a time.  For each chunk it computes,
in float32 as the reference does,

* ``y``     — the causal decay-weighted attention-like part
  ``y_i = Σ_{j ≤ i} (C_i · B_j) · exp(cum_i − cum_j) · dt_j · x_j``;
* ``state`` — the end-of-chunk state ``Σ_j exp(cum_last − cum_j)·dt_j·B_j x_jᵀ``,

which the inter-chunk recurrence then combines.  For i < j the decay
``exp(cum_i − cum_j)`` may overflow to inf: it is selected away with
``torch.where``, never multiplied by a 0/1 mask (inf·0 = NaN).

Used for CPU tensors and by the tests; the card runs ``csrc/ssd.cu``.
"""
from __future__ import annotations

import torch


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
    cs = x.shape[-2]
    grouped = x.ndim == 5 and B.shape[1] != x.shape[1]
    if grouped:  # (b, H, ...) → (b, G, H/G, ...) against B/C as (b, G, 1, ...)
        G = B.shape[1]
        x, dt, cum = (t.unflatten(1, (G, x.shape[1] // G)) for t in (x, dt, cum))
        B, C = B.unsqueeze(2), C.unsqueeze(2)
    xf, dtf, cumf = x.float(), dt.float(), cum.float()
    Bf, Cf = B.float(), C.float()
    diff = cumf[..., :, None] - cumf[..., None, :]
    ii = torch.arange(cs, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    L = torch.where(causal, torch.exp(diff), torch.zeros((), device=x.device))
    scores = (Cf @ Bf.transpose(-1, -2)) * L * dtf[..., None, :]
    y = scores @ xf  # (..., cs, P)
    decay_end = torch.exp(cumf[..., -1:] - cumf)
    state = (Bf * (decay_end * dtf)[..., None]).transpose(-1, -2) @ xf  # (..., N, P)
    if grouped:
        y, state = y.flatten(1, 2), state.flatten(1, 2)
    return y, state
