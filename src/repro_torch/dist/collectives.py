"""Task-graph collectives and gradient compression (paper §4.4): the
port's copy of ``repro.dist.collectives``, on torch tensors.

* **Eager / transport** — :func:`ring_all_reduce`, :func:`ring_all_gather`
  and :func:`hierarchical_all_reduce` build the ring pipelines out of
  ``mpi_send`` / ``mpi_recv`` *communication tasks* over whatever
  :class:`~repro_torch.core.SpTransport` the
  :class:`~repro_torch.core.SpCommGroup` carries — the in-process
  :class:`~repro_torch.core.ChannelHub` or the cross-process
  :class:`~repro_torch.core.SocketTransport` (one OS process per rank,
  ``launch/rendezvous.py``).  Every chunk hop is an ordinary graph node,
  so the scheduler sees (and can overlap) the whole reduce-scatter /
  all-gather pipeline.  Payloads may live on the card: the split cells are
  views of ``x``, each sum allocates (``ring.acc`` never adds in place, so
  a tensor already handed to the wire — which an in-process receiver
  aliases — is never written), and a group with ``device=`` receives onto
  that device.  Chunk boundaries are ``np.array_split``'s
  (``torch.tensor_split`` of the flat tensor), so the sums' order — and
  with it every bit — matches ``repro``'s.

* **Mesh** — the ``axis=`` spelling (``jax.lax`` collectives inside
  ``shard_map`` in ``repro``) runs ``torch.distributed`` collectives on the
  process group of one axis of the active mesh (``dist.sharding.use_mesh``;
  NCCL on cards, gloo on the CPU); :func:`hierarchical_psum` is the
  pod-aware three-stage variant (intra-pod reduce-scatter → inter-pod
  all-reduce on the scattered shards → intra-pod all-gather) that keeps the
  slow inter-pod links moving ``1/inner`` of the bytes.  Like ``jax.lax``'s,
  they return new tensors and leave their input as it was.

* **The model axis** — the tensor-parallel operators of a model built on
  a mesh with a ``model`` axis (``dist.sharding.ModelAxis``), as
  ``torch.autograd.Function``s: :func:`copy_to_model` (the identity
  forward, a sum over ``model`` backward: where a replicated activation
  enters a sharded region) and :func:`reduce_from_model` (a sum over
  ``model`` forward, the identity backward: where the region's partial
  results leave it); :func:`model_max_` and :func:`model_sum_` reduce in
  place, untracked (a softmax's row max, a norm's squares), and
  :func:`model_all_gather` stacks every rank's tensor (serving: a new
  token's heads, the decode slices' partial results, the greedy argmax).
  ``torch.distributed.nn.functional.all_reduce`` is not used: its backward
  sums again, which is wrong for :func:`reduce_from_model`.  GSPMD puts the
  same collectives into ``repro``'s programs.

* **The dry run's seam** — every ``torch.distributed`` collective above
  goes through :func:`comm_backend` of its group: ``torch.distributed``
  itself for a real process group (the same calls and bits as ever), or a
  :class:`RecordingGroup`, a dry run's stand-in that a
  ``dist.sharding.DryRunMesh`` hands out, which records the collective
  into a :class:`CollectiveLog` (kind, payload and ring wire bytes by
  ``repro``'s convention, group size) and leaves the tensors as they are.

Gradient compression (:func:`compress_int8` … :func:`compress_tree`):
symmetric per-tensor int8 with error-feedback residuals.  Trees are dicts
(nested or flat) of tensors; each tensor is one leaf with its own scale.
:func:`int8_scale` takes several tensors, so a caller that holds one of
``repro``'s stacked leaves as per-layer tensors quantizes them with the
scale of the whole leaf.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.access import SpData
from repro_torch.core.api import sp_task
from repro_torch.core.comm import SpCommGroup, mpi_recv, mpi_send
from repro_torch.core.graph import SpTaskGraph
from repro_torch.core.task import TaskView
from repro_torch.dist.sharding import current_mesh

# ---------------------------------------------------------------------------
# Ring collectives over a transport (eager task-graph substrate).
# The chunk-level steps are codelets — declared once here, instantiated per
# rank/step with per-call names (the codelet frontend, core/api.py).
# ---------------------------------------------------------------------------

@sp_task(read=("x",), write=("chunks",), name="ring.split")
def _ring_split(x, chunks, *, n, pieces, meta):
    """Scatter ``x`` into ``n`` rank-chunks of ``pieces`` pipeline pieces
    each (``len(chunks) == n * pieces``, flat order); stash shape/dtype in
    ``meta``."""
    a = torch.as_tensor(x)
    if not a.is_contiguous():
        a = a.contiguous()
    meta["shape"], meta["dtype"] = a.shape, a.dtype
    k = 0
    # contiguous 1-D slices: the cells hold zero-copy views into x's
    # storage, sent as-is.  Nothing downstream writes them in place
    # (accumulate allocates, concat reads), and the final concat *rebinds*
    # x.value rather than writing through it, so the aliasing is safe.
    for part in torch.tensor_split(a.reshape(-1), n):
        for piece in torch.tensor_split(part, pieces):
            chunks[k].value = piece
            k += 1


@sp_task(read=("incoming",), write=("acc",), name="ring.acc")
def _ring_accumulate(incoming, acc):
    # a new tensor, never acc.value.add_(...): the old value may be a view
    # of x or a tensor another rank still aliases
    acc.value = acc.value + incoming


@sp_task(read=("chunks",), write=("x",), name="ring.concat")
def _ring_concat(chunks, x, *, n, op, meta):
    full = torch.cat([v.reshape(-1) for v in chunks])
    if op == "mean":
        # numpy's promotion: an integer (or bool) array divided by an int
        # is float64, so an integer mean truncates exactly as repro's does
        full = (full if full.is_floating_point() else full.double()) / n
    x.value = full.to(meta["dtype"]).reshape(meta["shape"])
    return x.value


@sp_task(read=("x",), write=("slot",), name="ring.seed")
def _ring_seed(x, slot):
    slot.value = x


@sp_task(read=("slots",), name="ring.collect")
def _ring_collect(slots):
    return list(slots)


@sp_task(read=("x",), name="ring.identity")
def _ring_identity(x, *, wrap=False):
    return [x] if wrap else x


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return np.asarray(v).nbytes


def _pipeline_pieces(x, n_chunks: int, chunk_bytes, *, max_pieces: int = 32) -> int:
    """How many fixed-size pipeline pieces each rank-chunk splits into.

    Derived from the cell's value at insert time; every rank holds a
    same-shaped tensor, so all ranks agree.  Cells whose value is produced
    later in the graph fall back to one piece (no pipelining) — again on
    every rank, so the wire tags still line up."""
    if not chunk_bytes:
        return 1
    v = x.value if isinstance(x, SpData) else None
    if v is None:
        return 1
    per_chunk = max(1, _nbytes(v) // max(n_chunks, 1))
    return max(1, min(max_pieces, -(-per_chunk // int(chunk_bytes))))


def _ring_reduce_scatter(graph, group, cells, pieces, tag) -> int:
    """Reduce-scatter phase over ``cells`` (``S * pieces`` flat, as laid
    out by ``_ring_split``).  After S−1 steps logical rank ``r`` owns the
    fully-reduced chunk ``(r+1) % S`` (all its pieces); returns that index.

    With ``pieces > 1`` the ring is *chunk pipelined*: every piece runs
    its own independent send/recv/accumulate chain, so the comm thread
    transfers piece ``p+1`` of a step while a worker is still reducing
    piece ``p`` — transfer overlaps reduction across ring steps."""
    S, r = group.logical_size, group.logical_rank
    right, left = group.to_physical(r + 1), group.to_physical(r - 1)
    for step in range(S - 1):
        send_idx = (r - step) % S
        recv_idx = (r - step - 1) % S
        for p in range(pieces):
            mpi_send(graph, group, cells[send_idx * pieces + p], dest=right,
                     tag=("rar", tag, "rs", step, p))
            tmp = SpData(None, f"ar{tag}.r{r}.rs{step}.p{p}")
            mpi_recv(graph, group, tmp, src=left,
                     tag=("rar", tag, "rs", step, p))
            _ring_accumulate(tmp, cells[recv_idx * pieces + p],
                             graph=graph, name=f"allreduce{tag}.acc{step}.{p}")
    return (r + 1) % S


def _ring_allgather_chunks(graph, group, cells, pieces, tag) -> None:
    """All-gather phase: circulate the reduced chunks (rank ``r`` starts
    owning chunk ``(r+1) % S``, the reduce-scatter postcondition)."""
    S, r = group.logical_size, group.logical_rank
    right, left = group.to_physical(r + 1), group.to_physical(r - 1)
    for step in range(S - 1):
        send_idx = (r + 1 - step) % S
        recv_idx = (r - step) % S
        for p in range(pieces):
            mpi_send(graph, group, cells[send_idx * pieces + p], dest=right,
                     tag=("rar", tag, "ag", step, p))
            mpi_recv(graph, group, cells[recv_idx * pieces + p], src=left,
                     tag=("rar", tag, "ag", step, p))


def ring_all_reduce(
    graph: SpTaskGraph,
    group: SpCommGroup,
    x: SpData,
    *,
    op: str = "sum",
    tag: int = 0,
    chunk_bytes: Optional[int] = None,
) -> TaskView:
    """Insert a chunked ring all-reduce for ``x`` into ``graph``.

    Every rank calls this with its own (graph, group, cell); the group's
    transport wires the rings together — in-process mailboxes or TCP
    sockets, same task graph either way.  ``x.value`` is replaced by the
    reduced tensor; the returned view's value is the same tensor.  ``op`` is
    ``"sum"`` or ``"mean"``.  2·(S−1) hops per chunk — bandwidth-optimal.
    Re-issuing with a fresh ``tag`` per step is safe: drained mailboxes are
    pruned by the transport, so per-step keys do not accumulate.

    ``chunk_bytes`` turns on chunk pipelining: each of the S rank-chunks
    is further split into ~``chunk_bytes``-sized pieces that travel as
    independent frames, so successive ring steps overlap transfer with
    reduction (piece *p* of step *k+1* is in flight while piece *q* of
    step *k* is still being accumulated).  Pass the same value on every
    rank.
    """
    if op not in ("sum", "mean"):
        raise ValueError(f"unsupported op {op!r}; use 'sum' or 'mean'")
    # Logical coordinates: the ring is laid out over group.members, so a
    # group shrunk after a rank death still forms a closed ring; neighbours
    # are translated back to physical ranks for the wire.
    S, r = group.logical_size, group.logical_rank
    if S == 1:
        return _ring_identity(x, graph=graph, name=f"allreduce{tag}.id")
    P = _pipeline_pieces(x, S, chunk_bytes)
    cells = [SpData(None, f"ar{tag}.r{r}.c{i}") for i in range(S * P)]
    meta: dict = {}

    _ring_split(x, cells, n=S, pieces=P, meta=meta,
                graph=graph, name=f"allreduce{tag}.split")
    _ring_reduce_scatter(graph, group, cells, P, tag)
    _ring_allgather_chunks(graph, group, cells, P, tag)
    return _ring_concat(cells, x, n=S, op=op, meta=meta,
                        graph=graph, name=f"allreduce{tag}.concat")


def ring_all_gather(
    graph: SpTaskGraph,
    group: SpCommGroup,
    x: SpData,
    *,
    tag: int = 0,
) -> TaskView:
    """Ring all-gather: the returned view's value is the list of every
    rank's ``x.value``, ordered by logical rank — i.e. by position in
    ``group.members`` (same list on all ranks)."""
    S, r = group.logical_size, group.logical_rank
    if S == 1:
        return _ring_identity(x, wrap=True, graph=graph, name=f"allgather{tag}.id")
    right, left = group.to_physical(r + 1), group.to_physical(r - 1)
    slots = [SpData(None, f"ag{tag}.r{r}.s{i}") for i in range(S)]
    _ring_seed(x, slots[r], graph=graph, name=f"allgather{tag}.seed")
    for step in range(S - 1):
        send_idx = (r - step) % S
        recv_idx = (r - step - 1) % S
        mpi_send(graph, group, slots[send_idx], dest=right,
                 tag=("rag", tag, step))
        mpi_recv(graph, group, slots[recv_idx], src=left,
                 tag=("rag", tag, step))
    return _ring_collect(slots, graph=graph, name=f"allgather{tag}.collect")


def _ring_circulate_reduce(graph, group, cell, tag) -> None:
    """Naive ring all-reduce of a single cell over ``group``: circulate
    every rank's original value around the ring, accumulating each arrival
    into ``cell``.  (G−1)·nbytes on the wire — used only for the inter-pod
    stage of :func:`hierarchical_all_reduce`, where the payload is already
    a ``1/pod_size`` shard."""
    G, q = group.logical_size, group.logical_rank
    if G == 1:
        return
    right, left = group.to_physical(q + 1), group.to_physical(q - 1)
    orig = SpData(None, f"hc{tag}.r{q}.orig")
    _ring_seed(cell, orig, graph=graph, name=f"hier{tag}.seed")
    carry = orig
    for step in range(G - 1):
        mpi_send(graph, group, carry, dest=right, tag=("hir", tag, step))
        nxt = SpData(None, f"hc{tag}.r{q}.s{step}")
        mpi_recv(graph, group, nxt, src=left, tag=("hir", tag, step))
        _ring_accumulate(nxt, cell, graph=graph, name=f"hier{tag}.acc{step}")
        carry = nxt  # forward what we just received, keep the sum local


def hierarchical_all_reduce(
    graph: SpTaskGraph,
    group: SpCommGroup,
    x: SpData,
    *,
    pod_size: int,
    op: str = "sum",
    tag: int = 0,
) -> TaskView:
    """Eager pod-aware all-reduce over the task graph — the transport-level
    mirror of ``repro``'s ``hierarchical_psum``'s three stages:

    1. intra-pod ring reduce-scatter (each pod member ends up owning one
       pod-reduced chunk),
    2. inter-pod all-reduce of that chunk across same-position members of
       every pod (``1/pod_size`` of the bytes on the slow links),
    3. intra-pod ring all-gather + concat back into ``x``.

    ``group.members`` is laid out pod-major: members ``[k*pod_size,
    (k+1)*pod_size)`` form pod ``k``.  Requires ``logical_size %
    pod_size == 0``.  Bit-exact against a flat sum whenever the values are
    exactly representable (e.g. integer-valued float32)."""
    if op not in ("sum", "mean"):
        raise ValueError(f"unsupported op {op!r}; use 'sum' or 'mean'")
    S, r = group.logical_size, group.logical_rank
    if S % pod_size != 0:
        raise ValueError(
            f"group size {S} is not divisible by pod_size {pod_size}"
        )
    if S == 1:
        return _ring_identity(x, graph=graph, name=f"hierar{tag}.id")
    pod, pos = r // pod_size, r % pod_size
    n_pods = S // pod_size
    intra = SpCommGroup(
        group.rank, group.size, group.hub,
        default_timeout=group.default_timeout,
        members=[group.to_physical(pod * pod_size + j) for j in range(pod_size)],
        device=group.device,
    )
    inter = SpCommGroup(
        group.rank, group.size, group.hub,
        default_timeout=group.default_timeout,
        members=[group.to_physical(k * pod_size + pos) for k in range(n_pods)],
        device=group.device,
    )
    cells = [SpData(None, f"har{tag}.r{r}.c{i}") for i in range(pod_size)]
    meta: dict = {}
    _ring_split(x, cells, n=pod_size, pieces=1, meta=meta,
                graph=graph, name=f"hierar{tag}.split")
    if pod_size > 1:
        owned = _ring_reduce_scatter(graph, intra, cells, 1, ("h", tag))
    else:
        owned = 0
    _ring_circulate_reduce(graph, inter, cells[owned], ("h", tag, pos))
    if pod_size > 1:
        _ring_allgather_chunks(graph, intra, cells, 1, ("h", tag))
    return _ring_concat(cells, x, n=S, op=op, meta=meta,
                        graph=graph, name=f"hierar{tag}.concat")


# ---------------------------------------------------------------------------
# Mesh collectives (torch.distributed on the active mesh's axis groups).
# ---------------------------------------------------------------------------

class CollectiveLog:
    """The collectives a dry run's step would make: one record a call, as
    ``repro``'s ``launch/dryrun.py::collective_stats`` counts an HLO
    instruction: ``bytes`` is the payload (the result; a reduce-scatter's
    operand), ``wire_bytes`` a ring's traffic a device (all-gather and
    reduce-scatter (g − 1)/g of the payload, all-reduce twice that).
    ``region`` (set by the dry run) names the part of the step each record
    falls in."""

    def __init__(self) -> None:
        self.records: list[dict] = []
        self.region = lambda: None

    def add(self, kind: str, nbytes: int, size: int, axis: str) -> None:
        wire = (2 if kind == "all-reduce" else 1) * nbytes * (size - 1) // max(size, 1)
        self.records.append(dict(kind=kind, bytes=nbytes, wire_bytes=wire, group_size=size, axis=axis,
                                 region=self.region()))


class RecordingGroup:
    """A dry run's stand-in for the process group of one mesh axis: it
    answers the ``torch.distributed`` calls this module makes on a group
    (:func:`comm_backend`), recording each collective into ``log`` and
    leaving every tensor as it is."""

    class ReduceOp:
        SUM = "sum"
        MAX = "max"

    def __init__(self, axis: str, size: int, log: CollectiveLog):
        self.axis, self.size, self.log = axis, size, log

    def get_world_size(self, group=None) -> int:
        return self.size

    def all_reduce(self, x, op=None, group=None) -> None:
        self.log.add("all-reduce", x.numel() * x.element_size(), self.size, self.axis)

    def reduce_scatter_tensor(self, out, inp, op=None, group=None) -> None:
        self.log.add("reduce-scatter", inp.numel() * inp.element_size(), self.size, self.axis)

    def all_gather_into_tensor(self, out, inp, group=None) -> None:
        self.log.add("all-gather", out.numel() * out.element_size(), self.size, self.axis)


def comm_backend(group):
    """What runs a collective on ``group``: the group itself when it is a
    dry run's :class:`RecordingGroup`, else ``torch.distributed``."""
    if isinstance(group, RecordingGroup):
        return group
    import torch.distributed as dist

    return dist


def _axis_group(axis: str):
    mesh = current_mesh()
    if mesh is None:
        raise ValueError(
            f"axis={axis!r} needs an active mesh: wrap the call in `with use_mesh(mesh):`"
        )
    return mesh.get_group(axis)


def mesh_psum_(x: torch.Tensor, axes) -> int:
    """Sum ``x`` in place over the mesh axes ``axes`` (a name or a tuple of
    names, reduced one after another); → the number of ranks summed."""
    n = 1
    for a in (axes,) if isinstance(axes, str) else axes:
        group = _axis_group(a)
        dist = comm_backend(group)
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        n *= dist.get_world_size(group)
    return n


def hierarchical_psum(x: torch.Tensor, *, pod_axis: str = "pod", inner_axis: str = "data"):
    """Pod-aware psum: reduce-scatter over ``inner_axis``, all-reduce the
    scattered shards over ``pod_axis``, all-gather over ``inner_axis``.

    Equal to the sum over both axes, but the slow inter-pod hop carries
    ``1/inner`` of the bytes.  Needs an active mesh with both axes;
    :func:`hierarchical_all_reduce` is its task-graph counterpart."""
    inner_g, pod_g = _axis_group(inner_axis), _axis_group(pod_axis)
    dist, pod_dist = comm_backend(inner_g), comm_backend(pod_g)
    inner = dist.get_world_size(inner_g)
    n = x.numel()
    flat = x.reshape(-1)
    pad = (-n) % inner
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    flat = flat.contiguous()
    piece = flat.new_empty(flat.numel() // inner)
    dist.reduce_scatter_tensor(piece, flat, op=dist.ReduceOp.SUM, group=inner_g)
    pod_dist.all_reduce(piece, op=pod_dist.ReduceOp.SUM, group=pod_g)
    full = torch.empty_like(flat)
    dist.all_gather_into_tensor(full, piece, group=inner_g)
    return full[:n].reshape(x.shape)


# ---------------------------------------------------------------------------
# The model axis: tensor-parallel operators (dist.sharding.ModelAxis).
# ---------------------------------------------------------------------------

def model_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` in place over the ranks of ``group`` (untracked)."""
    dist = comm_backend(group)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def model_max_(x: torch.Tensor, group) -> torch.Tensor:
    """Max of ``x`` in place over the ranks of ``group`` (untracked)."""
    dist = comm_backend(group)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def model_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` over ``group``, stacked on a new leading axis in
    the group's rank order (untracked): (m, *x.shape)."""
    dist = comm_backend(group)
    n = dist.get_world_size(group)
    out = x.new_empty(n * x.numel())
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1), group=group)
    return out.reshape((n,) + tuple(x.shape))


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return model_sum_(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return model_sum_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _group_rank(group) -> int:
    """This process's rank in ``group`` (0 on a dry run's recording group,
    whose mesh answers rank 0 of every axis)."""
    if isinstance(group, RecordingGroup):
        return 0
    import torch.distributed as dist

    return dist.get_rank(group)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, partial):
        ctx.group, ctx.dim, ctx.partial = group, dim, partial
        return torch.cat(list(model_all_gather(x, group).unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        dist = comm_backend(ctx.group)
        m = dist.get_world_size(ctx.group)
        if not ctx.partial:  # every rank holds the whole gradient: its slice
            return g.chunk(m, dim=ctx.dim)[_group_rank(ctx.group)].contiguous(), None, None, None
        # every rank holds a part of it: the sum's slice, one reduce-scatter
        pieces = g.movedim(ctx.dim, 0).contiguous()
        out = pieces.new_empty((pieces.shape[0] // m,) + tuple(pieces.shape[1:]))
        dist.reduce_scatter_tensor(out, pieces, op=dist.ReduceOp.SUM, group=ctx.group)
        return out.movedim(0, ctx.dim).contiguous(), None, None, None


def gather_from_model(x: torch.Tensor, group, dim: int, partial: bool = True) -> torch.Tensor:
    """Every rank's ``x`` over ``group`` put together along ``dim`` in rank
    order (one all-gather).  Its gradient is this rank's slice of the
    gradient: of its sum over ``group`` (one reduce-scatter) when each rank
    uses the whole tensor in a sharded region and so holds a part of the
    gradient (``partial``), of its own when each rank computes the same
    whole gradient (``partial=False``)."""
    return _GatherFromModel.apply(x, group, dim % x.dim(), partial)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group`` (each rank's
    sharded region contributes a part of it)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its gradient passed through (the
    sum is replicated, so is its gradient)."""
    return _ReduceFromModel.apply(x, group)


# ---------------------------------------------------------------------------
# Substrate-dispatching spellings.
# ---------------------------------------------------------------------------

def all_reduce(
    x,
    *,
    axis=None,
    graph: Optional[SpTaskGraph] = None,
    group: Optional[SpCommGroup] = None,
    op: str = "sum",
    tag: int = 0,
):
    """Substrate-dispatching all-reduce: with (graph, group) → the ring
    over the group's transport; with ``axis`` (a mesh axis name, or a tuple
    of them) → ``torch.distributed`` on the active mesh: the sum, or the
    mean as ``jax.lax.pmean`` gives it."""
    if graph is not None:
        if group is None:
            raise ValueError("hub all_reduce needs both graph and group")
        return ring_all_reduce(graph, group, x, op=op, tag=tag)
    if axis is None:
        raise ValueError("all_reduce needs graph= and group=, or axis=<mesh axis name>")
    if op not in ("sum", "mean"):
        raise ValueError(f"unsupported op {op!r}; use 'sum' or 'mean'")
    y = x.clone()
    n = mesh_psum_(y, axis)
    return y.div_(n) if op == "mean" else y


def all_gather(
    x,
    *,
    axis=None,
    graph: Optional[SpTaskGraph] = None,
    group: Optional[SpCommGroup] = None,
    tag: int = 0,
):
    """Substrate-dispatching all-gather (see :func:`all_reduce`); on a mesh
    axis every rank's ``x`` stacked on a new leading axis, in the axis's
    rank order, as untiled ``jax.lax.all_gather``."""
    if graph is not None:
        if group is None:
            raise ValueError("hub all_gather needs both graph and group")
        return ring_all_gather(graph, group, x, tag=tag)
    if axis is None:
        raise ValueError("all_gather needs graph= and group=, or axis=<mesh axis name>")
    return model_all_gather(x, _axis_group(axis))


# ---------------------------------------------------------------------------
# Gradient compression with error feedback.
# ---------------------------------------------------------------------------

def int8_scale(*tensors: torch.Tensor, eps: float = 1e-8, group=None) -> torch.Tensor:
    """max|g| / 127 over all ``tensors`` (float32), at least ``eps`` / 127;
    with ``group`` the max is also taken over its ranks (a leaf sharded
    over the ``model`` axis quantizes with the scale of the whole leaf)."""
    amax = torch.stack([t.detach().abs().amax().float() for t in tensors]).amax()
    if group is not None:
        amax = model_max_(amax.reshape(1), group)[0]
    return torch.clamp(amax, min=eps) / 127.0


def compress_int8(g: torch.Tensor, *, eps: float = 1e-8, scale=None):
    """Symmetric per-tensor int8 quantization: ``(q, scale)`` with
    ``q = round(g / scale)`` and ``scale = max|g| / 127`` (or the given
    one).  The round-trip error of every element is bounded by
    ``scale / 2``."""
    g = g.float()
    if scale is None:
        scale = int8_scale(g, eps=eps)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def init_residuals(grads):
    """Zero error-feedback residuals shaped like ``grads`` (float32)."""
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compress_tree(grads, residuals):
    """Quantize-dequantize every leaf with error feedback.

    Returns ``(dequantized, new_residuals)``: the residual (what int8 lost
    this step) is added back before quantizing next step, so the long-run
    mean of the dequantized stream converges to the true gradient.
    """
    def one(g, r):
        corrected = g.float() + r
        deq = decompress_int8(*compress_int8(corrected))
        return deq, corrected - deq

    pairs = _map(one, grads, residuals)
    return _map(lambda p: p[0], pairs), _map(lambda p: p[1], pairs)
