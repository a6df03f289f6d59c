"""Distributed pieces of the port: communication folded into the task graph
(paper §4.4).

* :mod:`repro_torch.dist.collectives` — ring :func:`ring_all_reduce` /
  :func:`ring_all_gather` and :func:`hierarchical_all_reduce` built from
  ``mpi_send`` / ``mpi_recv`` communication tasks over any
  :class:`~repro_torch.core.SpTransport` (the in-process
  :class:`~repro_torch.core.ChannelHub`, the cross-process
  :class:`~repro_torch.core.SocketTransport`), on torch tensors that may
  live on the card; gradient compression (:func:`compress_int8` /
  :func:`compress_tree` with error-feedback residuals).
* :mod:`repro_torch.dist.fault` — duplicated tasks, failure injection
  (:class:`FaultyTransport`), bounded retry (:class:`RetryingTransport`),
  :class:`FailureSimulator` and :func:`remesh_plan`.

``launch/rendezvous.py`` spawns one OS process per rank over the socket
transport.  Still to port (ROADMAP.md, Queue 1 item 5): ``dist/chaos.py``,
``dist/sharding.py`` and the ``axis=`` collectives on a device mesh.
"""
from .collectives import (
    all_gather,
    all_reduce,
    compress_int8,
    compress_tree,
    decompress_int8,
    hierarchical_all_reduce,
    hierarchical_psum,
    init_residuals,
    int8_scale,
    ring_all_gather,
    ring_all_reduce,
)
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
    "all_gather", "all_reduce", "compress_int8", "compress_tree",
    "decompress_int8", "hierarchical_all_reduce", "hierarchical_psum",
    "init_residuals", "int8_scale", "ring_all_gather", "ring_all_reduce",
    "CancelToken", "FailureSimulator", "FaultyTransport", "RetryingTransport",
    "RemeshPlan", "remesh_plan", "run_duplicated",
]
