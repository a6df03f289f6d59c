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

Sharding: :func:`axes_tree` and :func:`sharding_tree` give each def's
logical axes and its ``PartitionSpec`` on a mesh (``dist.sharding.safe_spec``,
as ``repro``'s ``sharding_tree`` gives ``NamedSharding``s);
:func:`local_index` is this rank's part of a global shape under a spec, and
:func:`init_` with ``index`` draws a leaf at its full shape and keeps that
part, so a rank's tensors are bit for bit the slices of the off-mesh init.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch.dist.sharding import PartitionSpec, mesh_shape, safe_spec, spec_axes

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the dtypes an input or cache ParamDef may name besides DTYPES'
INPUT_DTYPES = {**DTYPES, "int32": torch.int32, "bool": torch.bool}


class Shard(NamedTuple):
    """A parameter's place in its leaf on a mesh: the full (unstacked)
    shape, its ``PartitionSpec`` and this rank's index into it."""

    full: tuple[int, ...]
    spec: PartitionSpec
    index: Optional[tuple[slice, ...]]

    @property
    def sharded(self) -> bool:
        return any(e is not None for e in self.spec)


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
def init_(t: torch.Tensor, d: ParamDef, gen: torch.Generator, index: Optional[tuple] = None) -> None:
    """Fill ``t`` (on its device) by the init rule of the unstacked ``d``;
    with ``index`` (:func:`local_index`) ``t`` is that part of the leaf,
    drawn at the leaf's full shape, so the generator advances as off-mesh."""
    want = tuple(d.shape) if index is None else tuple(len(range(*i.indices(n))) for i, n in zip(index, d.shape))
    if tuple(t.shape) != want:
        raise ValueError(f"parameter shape {tuple(t.shape)} != def {d.shape} (part {want})")
    if d.init == "zeros":
        t.zero_()
    elif d.init == "ones":
        t.fill_(1.0)
    elif d.init == "const":
        t.fill_(d.scale or 0.0)
    else:
        draw = torch.randn(d.shape, generator=gen, device=t.device, dtype=torch.float32)
        draw.mul_(_stddev(d))
        t.copy_(draw if index is None else draw[index])


def _map_defs(fn, defs):
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: _map_defs(fn, v) for k, v in defs.items()}


def axes_tree(defs):
    """Each def's logical axes, in the defs' tree."""
    return _map_defs(lambda d: d.axes, defs)


def sharding_tree(defs, mesh=None):
    """Each def's ``PartitionSpec`` on ``mesh`` (default: the active mesh;
    all-None off-mesh), by ``safe_spec``: ``repro``'s ``sharding_tree``."""
    return _map_defs(lambda d: safe_spec(d.shape, d.axes, mesh=mesh), defs)


def local_shape(shape, spec: PartitionSpec, mesh) -> tuple[int, ...]:
    """Each rank's part of a ``shape`` laid out by ``spec`` on ``mesh``
    (``safe_spec`` only gives specs whose axes divide their dims)."""
    sizes = mesh_shape(mesh) if mesh is not None else {}
    out = []
    for n, entry in zip(shape, spec):
        k = math.prod(sizes[a] for a in spec_axes(entry))
        out.append(n // k)
    return tuple(out)


def local_index(shape, spec: PartitionSpec, mesh) -> tuple[slice, ...]:
    """This rank's part of a ``shape`` laid out by ``spec``: per dim, the
    range of its shard (the shard's number counts over the entry's mesh
    axes, major to minor, from ``mesh.get_local_rank(axis)``)."""
    sizes = mesh_shape(mesh) if mesh is not None else {}
    out = []
    for n, entry in zip(shape, spec):
        index, k = 0, 1
        for a in spec_axes(entry):
            index, k = index * sizes[a] + mesh.get_local_rank(a), k * sizes[a]
        step = n // k
        out.append(slice(index * step, (index + 1) * step))
    return tuple(out)



def abstract_tree(defs, dtype: str):
    """A ParamDef tree → the same tree of ``meta`` tensors (shape and dtype,
    no storage; ``dtype`` where a def names none), as ``repro``'s
    ``abstract_tree`` gives ``ShapeDtypeStruct``s."""
    if isinstance(defs, ParamDef):
        return torch.empty(defs.shape, dtype=INPUT_DTYPES[defs.dtype or dtype], device="meta")
    return {k: abstract_tree(v, dtype) for k, v in defs.items()}
