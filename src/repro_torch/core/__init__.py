"""The Specx task runtime, the port's own copy of ``repro.core``.

Sequential-task-flow graphs with the paper's five access modes,
worker-thread compute engines with pluggable schedulers, commit/rollback
speculation, the codelet frontend, the staged backend (``staged.py``: one
policy-chosen order, run on the calling thread), communication as tasks
(``comm.py``: the comm thread, the in-process and socket transports, whose
payloads are torch tensors) and the elastic runtime
(``SpRuntime(elastic=True)``).  Only ``comm.py`` imports ``torch``; none
imports ``jax``.  The device implementation kind is ``"cuda"`` (``repro``
says ``"pallas"``)::

    from repro_torch.core import SpData, SpRuntime, sp_task

    @sp_task(read=("a",), write=("b",))
    def axpy(a, b, *, alpha=2.0):
        b.value = b.value + alpha * a

    with SpRuntime(workers=4) as rt:
        view = axpy(SpData(1.0), SpData(2.0))
"""
from .access import (
    AccessMode,
    SpAccess,
    SpArrayAccess,
    SpAtomicWrite,
    SpAtomicWriteArray,
    SpCommutativeWrite,
    SpCommutativeWriteArray,
    SpCpu,
    SpCuda,
    SpData,
    SpHip,
    SpHost,
    SpImpl,
    SpMaybeWrite,
    SpMaybeWriteArray,
    SpPriority,
    SpRead,
    SpReadArray,
    SpRef,
    SpWrite,
    SpWriteArray,
    SpWriteRef,
)
from .comm import (
    ChannelHub,
    RouterTransport,
    SocketTransport,
    SpCommAbortedError,
    SpCommError,
    SpCommGroup,
    SpCommTimeoutError,
    SpCommTransientError,
    SpDeserializer,
    SpRankDeadError,
    SpSerializer,
    SpTransport,
    decode_message,
    default_hub,
    encode_message,
    mpi_broadcast,
    mpi_recv,
    mpi_send,
    register_wire_type,
    reset_default_hub,
)
from .api import (
    ElasticEvent,
    SpCodelet,
    SpRuntime,
    SpSlot,
    current_graph,
    graph_scope,
    sp_task,
)
from .engine import SpComputeEngine, SpWorker, SpWorkerTeam, SpWorkerTeamBuilder
from .graph import SpSpeculativeModel, SpTaskGraph
from .scheduler import (
    CriticalPathScheduler,
    FifoScheduler,
    LifoScheduler,
    PriorityScheduler,
    SpAbstractScheduler,
    WorkStealingScheduler,
    compute_upward_ranks,
    make_scheduler,
)
from .staged import execute_staged, linearize, schedule_summary
from .task import SpTaskPolicy, SpTaskTimeoutError, Task, TaskState, TaskView
from .trace import trace_metrics

__all__ = [
    "AccessMode", "SpAccess", "SpArrayAccess", "SpAtomicWrite", "SpAtomicWriteArray",
    "SpCommutativeWrite", "SpCommutativeWriteArray", "SpCpu", "SpCuda", "SpData",
    "SpHip", "SpHost", "SpImpl", "SpMaybeWrite", "SpMaybeWriteArray", "SpPriority", "SpRead",
    "SpReadArray", "SpRef", "SpWrite", "SpWriteArray", "SpWriteRef",
    "ChannelHub", "RouterTransport", "SocketTransport", "SpTransport", "SpCommGroup",
    "SpCommError", "SpCommTimeoutError", "SpCommAbortedError",
    "SpCommTransientError", "SpRankDeadError", "SpDeserializer", "SpSerializer",
    "decode_message", "default_hub", "encode_message", "register_wire_type",
    "reset_default_hub", "mpi_broadcast", "mpi_recv", "mpi_send",
    "ElasticEvent", "SpCodelet", "SpRuntime", "SpSlot", "current_graph",
    "graph_scope", "sp_task",
    "SpComputeEngine", "SpWorker", "SpWorkerTeam", "SpWorkerTeamBuilder",
    "SpSpeculativeModel", "SpTaskGraph", "CriticalPathScheduler", "FifoScheduler",
    "LifoScheduler", "PriorityScheduler", "SpAbstractScheduler",
    "WorkStealingScheduler", "compute_upward_ranks", "make_scheduler",
    "execute_staged", "linearize", "schedule_summary",
    "SpTaskPolicy", "SpTaskTimeoutError", "Task", "TaskState", "TaskView",
    "trace_metrics",
]
