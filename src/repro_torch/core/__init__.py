"""The Specx task runtime, the port's own copy of ``repro.core``.

Pure Python (no ``torch``, no ``jax``): sequential-task-flow graphs with the
paper's five access modes, worker-thread compute engines with pluggable
schedulers, commit/rollback speculation, and the codelet frontend.  What the
copy leaves out until the distributed slice: the comm layer (``comm.py``),
the staged backend (``staged.py``) and the elastic runtime.  The device
implementation kind is ``"cuda"`` (``repro`` says ``"pallas"``)::

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
from .api import SpCodelet, SpRuntime, SpSlot, current_graph, graph_scope, sp_task
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
from .task import SpTaskPolicy, SpTaskTimeoutError, Task, TaskState, TaskView
from .trace import trace_metrics

__all__ = [
    "AccessMode", "SpAccess", "SpArrayAccess", "SpAtomicWrite", "SpAtomicWriteArray",
    "SpCommutativeWrite", "SpCommutativeWriteArray", "SpCpu", "SpCuda", "SpData",
    "SpHost", "SpImpl", "SpMaybeWrite", "SpMaybeWriteArray", "SpPriority", "SpRead",
    "SpReadArray", "SpRef", "SpWrite", "SpWriteArray", "SpWriteRef",
    "SpCodelet", "SpRuntime", "SpSlot", "current_graph", "graph_scope", "sp_task",
    "SpComputeEngine", "SpWorker", "SpWorkerTeam", "SpWorkerTeamBuilder",
    "SpSpeculativeModel", "SpTaskGraph", "CriticalPathScheduler", "FifoScheduler",
    "LifoScheduler", "PriorityScheduler", "SpAbstractScheduler",
    "WorkStealingScheduler", "compute_upward_ranks", "make_scheduler",
    "SpTaskPolicy", "SpTaskTimeoutError", "Task", "TaskState", "TaskView",
    "trace_metrics",
]
