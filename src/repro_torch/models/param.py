"""Parameter definitions: one source of truth for shapes and initialisers.

A port of ``repro.models.param``.  Each model module exposes
``*_defs(cfg) -> dict[str, ParamDef | dict]`` with the JAX package's keys and
weight layouts (e.g. ``wq (D, H, Dh)``), so a parameter tree carries across
by copying (``repro_torch.bridge``).  :func:`stack_defs` prepends the layer
axis as in ``repro``; the port's modules hold the layers unstacked in a
``ModuleList`` and :func:`init_` draws each layer's tensors.

Initialisation follows ``repro.models.param.init_tree``: ``normal`` with
stddev 1/sqrt(fan_in), ``embed`` with stddev 1, ``zeros`` for the norm
offsets, ``ones`` and ``const`` (filled with ``scale``) for the SSM's
``A_log``, ``D`` and ``dt_bias``.  Values are drawn on the target device from a seeded
``torch.Generator`` in float32 one leaf (one layer) at a time and cast to the
parameter dtype, so the full model never exists in float32, and nothing is
materialised on the host.  ``torch`` cannot replay ``jax.random``, so the
values differ from ``repro``'s; parity tests bridge ``repro``'s weights.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the dtypes an input or cache ParamDef may name besides DTYPES'
INPUT_DTYPES = {**DTYPES, "int32": torch.int32, "bool": torch.bool}


@dataclass
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | const | embed
    dtype: Optional[str] = None  # None → model dtype
    scale: Optional[float] = None  # stddev override

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} / axes {self.axes} rank mismatch")


def stack_defs(defs, n: int):
    """Prepend a ``layers`` dimension to every leaf."""
    if isinstance(defs, ParamDef):
        return ParamDef((n,) + defs.shape, ("layers",) + defs.axes, defs.init, defs.dtype, defs.scale)
    return {k: stack_defs(v, n) for k, v in defs.items()}


def _stddev(d: ParamDef) -> float:
    if d.scale is not None:
        return d.scale
    if d.init == "embed":
        return 1.0
    fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[-1], 1)
    return 1.0 / math.sqrt(max(fan_in, 1))


@torch.no_grad()
def init_(t: torch.Tensor, d: ParamDef, gen: torch.Generator) -> None:
    """Fill ``t`` (on its device) by the init rule of the unstacked ``d``."""
    if tuple(t.shape) != tuple(d.shape):
        raise ValueError(f"parameter shape {tuple(t.shape)} != def {d.shape}")
    if d.init == "zeros":
        t.zero_()
    elif d.init == "ones":
        t.fill_(1.0)
    elif d.init == "const":
        t.fill_(d.scale or 0.0)
    else:
        draw = torch.randn(d.shape, generator=gen, device=t.device, dtype=torch.float32)
        t.copy_(draw.mul_(_stddev(d)))



def abstract_tree(defs, dtype: str):
    """A ParamDef tree → the same tree of ``meta`` tensors (shape and dtype,
    no storage; ``dtype`` where a def names none), as ``repro``'s
    ``abstract_tree`` gives ``ShapeDtypeStruct``s."""
    if isinstance(defs, ParamDef):
        return torch.empty(defs.shape, dtype=INPUT_DTYPES[defs.dtype or dtype], device="meta")
    return {k: abstract_tree(v, dtype) for k, v in defs.items()}
