"""The port's distributed layer: sharding, collectives, fault tolerance and
the chaos soak — communication folded into the task graph (paper §4.4).

* :mod:`repro_torch.dist.sharding` — mesh context (:func:`use_mesh` /
  :func:`current_mesh`) and logical-axis sharding rules
  (:func:`default_rules`, :func:`safe_spec`, :func:`named_sharding`,
  :func:`shard`) on ``torch.distributed``'s ``DeviceMesh``; off-mesh every
  helper is the identity; :func:`model_axis` gives a mesh's ``model`` axis
  (size, this rank's coordinate, process group) to tensor-parallel code.
* :mod:`repro_torch.dist.collectives` — ring :func:`ring_all_reduce` /
  :func:`ring_all_gather` and :func:`hierarchical_all_reduce` built from
  ``mpi_send`` / ``mpi_recv`` communication tasks over any
  :class:`~repro_torch.core.SpTransport` (the in-process
  :class:`~repro_torch.core.ChannelHub`, the cross-process
  :class:`~repro_torch.core.SocketTransport`), on torch tensors that may
  live on the card; gradient compression (:func:`compress_int8` /
  :func:`compress_tree` with error-feedback residuals); on a mesh, the
  ``axis=`` spelling of :func:`all_reduce` / :func:`all_gather` and the
  pod-aware :func:`hierarchical_psum` run ``torch.distributed`` collectives
  on the mesh axes' process groups (NCCL on cards, gloo on the CPU); the
  tensor-parallel operators :func:`copy_to_model` / :func:`reduce_from_model`
  (autograd functions) and the in-place :func:`model_sum_` /
  :func:`model_max_` on the ``model`` axis' group.
* :mod:`repro_torch.dist.fault` — duplicated tasks, failure injection
  (:class:`FaultyTransport`), bounded retry (:class:`RetryingTransport`),
  :class:`FailureSimulator` and :func:`remesh_plan`.
* :mod:`repro_torch.dist.chaos` — the seeded chaos soak over the three
  recovery surfaces (:func:`chaos_collectives`, :func:`chaos_elastic`,
  :func:`chaos_serve`; ``python -m repro_torch.dist.chaos``).

``launch/rendezvous.py`` spawns one OS process per rank over the socket
transport; ``launch/mesh.py`` builds device meshes over an initialised
process group.
"""
from .sharding import (
    ModelAxis,
    current_mesh,
    default_rules,
    model_axis,
    named_sharding,
    safe_spec,
    shard,
    use_mesh,
)
from .collectives import (
    all_gather,
    all_reduce,
    compress_int8,
    compress_tree,
    copy_to_model,
    decompress_int8,
    hierarchical_all_reduce,
    hierarchical_psum,
    init_residuals,
    int8_scale,
    model_max_,
    model_sum_,
    reduce_from_model,
    ring_all_gather,
    ring_all_reduce,
)
from .chaos import chaos_collectives, chaos_elastic, chaos_serve
from .fault import (
    CancelToken,
    FailureSimulator,
    FaultyTransport,
    RemeshPlan,
    RetryingTransport,
    remesh_plan,
    run_duplicated,
)

__all__ = [
    "ModelAxis", "current_mesh", "default_rules", "model_axis", "named_sharding", "safe_spec", "shard",
    "use_mesh", "all_gather", "all_reduce", "compress_int8", "compress_tree", "copy_to_model",
    "decompress_int8", "hierarchical_all_reduce", "hierarchical_psum",
    "init_residuals", "int8_scale", "model_max_", "model_sum_", "reduce_from_model",
    "ring_all_gather", "ring_all_reduce",
    "CancelToken", "FailureSimulator", "FaultyTransport", "RetryingTransport",
    "RemeshPlan", "remesh_plan", "run_duplicated",
    "chaos_collectives", "chaos_elastic", "chaos_serve",
]
