"""Mesh context and logical-axis sharding rules on ``torch.distributed``'s
:class:`~torch.distributed.device_mesh.DeviceMesh` — the port of
``repro.dist.sharding``.

Models never mention mesh axes.  They name *logical* axes ("batch",
"heads", "ff", ...), and a rules table maps them onto the axes of whatever
mesh is active:

* ``use_mesh(mesh)`` pushes a mesh context (a plain context manager; the
  stack lives in a :class:`contextvars.ContextVar`, so nested contexts stay
  isolated.  Helper threads — prefetch, checkpoint commit, engine workers —
  start from an *empty* context and deliberately see no mesh: :func:`shard`
  is the identity there);
* :func:`safe_spec` turns (shape, logical axes) into a
  :class:`PartitionSpec`, *replicating* any dimension the mesh cannot
  divide evenly, so a shrunken mesh can always load the same model, at worst
  with less parallelism;
* :func:`named_sharding` gives that spec as DTensor placements
  (``Shard(d)`` / ``Replicate()``, one per mesh axis) on the active mesh;
* off-mesh (no ``use_mesh`` active) every helper is the identity, so the
  same model code runs unsharded on one card;
* :func:`model_axis` gives the ``model`` axis of a mesh as a
  :class:`ModelAxis` (its size, this rank's place on it and its process
  group), or None when the mesh has no ``model`` axis larger than 1: the
  tensor-parallel model code asks it once, when a model is built.

A mesh here is a ``DeviceMesh`` with ``mesh_dim_names``; :func:`safe_spec`
also takes any object whose ``.shape`` maps axis names to sizes, so plans
can be checked without a process group.  :class:`DryRunMesh` is such an
object that a model and a train step can also be built and run on (on the
``meta`` device): rank 0 of every axis, with groups that record their
collectives instead of running them (``launch/dryrun.py``).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Sequence

_mesh_stack: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_mesh_stack", default=()
)


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (replicated), a mesh axis name,
    or a tuple of mesh axis names (major to minor)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` for the dynamic extent of the ``with`` block."""
    token = _mesh_stack.set(_mesh_stack.get() + (mesh,))
    try:
        yield mesh
    finally:
        _mesh_stack.reset(token)


def current_mesh():
    """The innermost active mesh, or ``None`` outside any ``use_mesh``."""
    stack = _mesh_stack.get()
    return stack[-1] if stack else None


def mesh_shape(mesh) -> dict:
    """Axis name → size: a ``DeviceMesh``'s ``mesh_dim_names`` / ``size(i)``,
    or the ``.shape`` mapping of a mesh-like object."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {name: mesh.size(i) for i, name in enumerate(names)}
    return dict(mesh.shape)


def default_rules() -> dict:
    """Logical axis → candidate mesh axes (major-to-minor preference).

    ``batch`` spreads over all pure-data axes (``pod`` × ``data``); tensor
    dimensions (heads, ff, experts, vocab, kv sequence) go to ``model``.
    Dimensions mapped to ``None`` are always replicated.  Each mesh axis is
    used at most once per spec; first dimension wins.
    """
    return {
        "batch": ("pod", "data"),
        "act_seq": None,       # activation sequence stays local to a shard
        "kv_seq": ("model",),  # decode KV caches are sequence-sharded
        "heads": ("model",),
        "kv_heads": ("model",),
        "ff": ("model",),
        "expert_ff": ("model",),
        "experts": ("model",),
        "vocab": ("model",),
        "embed": None,
        "head_dim": None,
        "layers": None,
    }


class ModelAxis:
    """The ``model`` axis of the mesh a model was built on.  It keeps the
    mesh, not the group: the backward (and a checkpointed layer's recompute)
    may run on autograd's device thread, which sees no ``use_mesh``."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.size = mesh_shape(mesh)["model"]

    @property
    def rank(self) -> int:
        """This rank's coordinate on the axis."""
        return self.mesh.get_local_rank("model")

    @property
    def group(self):
        """The axis' process group (the ranks that share every other
        coordinate)."""
        return self.mesh.get_group("model")


class DryRunMesh:
    """A mesh without processes, for a dry run: ``shape`` maps axis names to
    sizes, :meth:`get_local_rank` answers rank 0 of every axis, and
    :meth:`get_group` gives each axis a recording stand-in
    (``dist.collectives.RecordingGroup``) whose collectives go into
    ``log`` (a ``CollectiveLog``) and leave their tensors as they are."""

    def __init__(self, shape: dict):
        from repro_torch.dist.collectives import CollectiveLog, RecordingGroup

        self.shape = dict(shape)
        self.log = CollectiveLog()
        self._groups = {a: RecordingGroup(a, n, self.log) for a, n in self.shape.items()}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def get_local_rank(self, axis: str) -> int:
        return 0

    def get_group(self, axis: str):
        return self._groups[axis]


class BatchAxes:
    """The axes of a mesh a step's rows are split over, each with more
    than one rank, major to minor (of ``default_rules()["batch"]``:
    ``pod``, ``data``).  Like :class:`ModelAxis` it keeps the mesh, for
    autograd's threads."""

    def __init__(self, mesh, axes: tuple):
        self.mesh = mesh
        self.axes = axes
        sizes = mesh_shape(mesh)
        self.sizes = tuple(sizes[a] for a in axes)
        self.size = math.prod(self.sizes)

    @property
    def rank(self) -> int:
        """This rank's block of rows: its coordinates on the axes, major to
        minor."""
        index = 0
        for a, n in zip(self.axes, self.sizes):
            index = index * n + self.mesh.get_local_rank(a)
        return index

    @property
    def groups(self) -> list:
        """Each axis' process group, major to minor."""
        return [self.mesh.get_group(a) for a in self.axes]


def batch_axes(mesh=None) -> Optional[BatchAxes]:
    """The batch axes of ``mesh`` (default: :func:`current_mesh`) with more
    than one rank, or None when there are none."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return None
    sizes = mesh_shape(mesh)
    axes = tuple(a for a in default_rules()["batch"] if sizes.get(a, 1) > 1)
    return BatchAxes(mesh, axes) if axes else None


_split_axes: contextvars.ContextVar[tuple] = contextvars.ContextVar("repro_torch_split_axes", default=())


def batch_split_axes(batch: int, mesh=None) -> tuple:
    """The mesh axes a global batch of ``batch`` rows splits over on
    ``mesh`` (default: :func:`current_mesh`), as :func:`safe_spec` lays it
    out, major to minor: () off-mesh and where the batch axes replicate
    it."""
    mesh = mesh if mesh is not None else current_mesh()
    return () if mesh is None else spec_axes(safe_spec((batch,), ("batch",), mesh=mesh)[0])


@contextlib.contextmanager
def split_rows(axes: Sequence[str]):
    """Declare, for the dynamic extent of the ``with`` block, that the rows
    a step runs on are this rank's block of a batch split over the mesh
    axes ``axes`` (:func:`batch_split_axes`).  The train step, the serve
    step and the dry run declare theirs; a MoE layer routes over the rows
    of every rank of a declared split (``models/moe.py``).  Undeclared, a
    rank's rows are the whole batch."""
    token = _split_axes.set(tuple(axes))
    try:
        yield
    finally:
        _split_axes.reset(token)


def rows_split(mesh=None) -> Optional[BatchAxes]:
    """The split :func:`split_rows` declares, on ``mesh`` (default:
    :func:`current_mesh`): its axes of more than one rank, or None when
    there are none and this rank's rows are the whole batch.  Read in the
    calling thread: the model passes it on to its layers, whose
    recomputation in the backward may run on autograd's threads."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return None
    sizes = mesh_shape(mesh)
    axes = tuple(a for a in _split_axes.get() if sizes.get(a, 1) > 1)
    return BatchAxes(mesh, axes) if axes else None


def model_axis(mesh=None) -> Optional[ModelAxis]:
    """The ``model`` axis of ``mesh`` (default: :func:`current_mesh`), or
    None off-mesh and when the axis is absent or of size 1."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or mesh_shape(mesh).get("model", 1) <= 1:
        return None
    return ModelAxis(mesh)


def spec_axes(entry) -> tuple:
    """A spec entry's mesh axes, major to minor: () for None."""
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_product(shape: dict, axes: Sequence[str]) -> int:
    return math.prod(shape[a] for a in axes)


def safe_spec(
    shape: Sequence[int],
    axes: Sequence[Optional[str]],
    *,
    mesh=None,
    rules: Optional[dict] = None,
) -> PartitionSpec:
    """PartitionSpec for ``shape`` under the rules, dropping anything the
    mesh cannot divide.  ``mesh`` defaults to :func:`current_mesh`."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} / axes {axes} rank mismatch")
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return PartitionSpec(*(None,) * len(shape))
    rules = rules if rules is not None else default_rules()
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    entries: list = []
    for dim, logical in zip(shape, axes):
        target = rules.get(logical) if logical is not None else None
        if target is None:
            entries.append(None)
            continue
        cand = [a for a in ((target,) if isinstance(target, str) else target)
                if a in sizes and a not in used]
        # drop major axes until the shard count divides the dimension
        while cand and dim % _axis_product(sizes, cand) != 0:
            cand.pop(0)
        if not cand:
            entries.append(None)
            continue
        used.update(cand)
        entries.append(cand[0] if len(cand) == 1 else tuple(cand))
    return PartitionSpec(*entries)


def _placements(spec: PartitionSpec, mesh) -> tuple:
    from torch.distributed.tensor import Replicate, Shard

    dim_of: dict = {}
    for d, entry in enumerate(spec):
        for a in (entry,) if isinstance(entry, str) else (entry or ()):
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate() for a in mesh.mesh_dim_names)


def named_sharding(
    shape: Sequence[int],
    axes: Sequence[Optional[str]],
    *,
    rules: Optional[dict] = None,
) -> tuple:
    """The DTensor placements of :func:`safe_spec`'s spec on the active mesh,
    one per mesh axis (requires a ``use_mesh`` context)."""
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError(
            "named_sharding() requires an active mesh; wrap the call in "
            "`with use_mesh(mesh):`"
        )
    return _placements(safe_spec(shape, axes, mesh=mesh, rules=rules), mesh)


def shard(x, *axes: Optional[str], rules: Optional[dict] = None):
    """Lay ``x`` out by logical axes: identity off-mesh and on a plain local
    tensor; a ``DTensor`` is redistributed to the spec's placements."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = safe_spec(x.shape, axes, mesh=x.device_mesh, rules=rules)
    return x.redistribute(x.device_mesh, _placements(spec, x.device_mesh))
