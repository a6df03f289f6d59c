"""Staged backend: run an STF task graph in one policy-chosen order.

The port's copy of ``repro.core.staged``.  Where ``repro`` traces the
ordered task bodies under ``jax.jit`` into one compiled SPMD program, the
port runs them eagerly, in that order, on the calling thread: PyTorch has no
tracing step that the port needs, and each body enqueues its work on the
card's current stream.  The scheduler's freedom (order among ready tasks,
placement of commutative writes, hoisting of communication) is still the
program order of the step:

1. build an :class:`~repro_torch.core.graph.SpTaskGraph` whose cells hold
   tensors, modules or dicts of them;
2. :func:`linearize` it — a Kahn topological sort whose tie-break is the
   pluggable scheduling policy;
3. :func:`run_schedule` runs the task bodies in that order, threading
   values through the cells.

Policies:

* ``fifo``          — insertion order (paper default; the sequential order).
* ``priority``      — SpPriority-descending among ready tasks.
* ``critical_path`` — HEFT upward rank (longest downstream cost first).
* ``overlap``       — communication-first: a ready comm task is always
  issued before ready compute tasks, so collectives start as early as the
  dependence structure allows.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable

from .graph import SpTaskGraph
from .scheduler import compute_upward_ranks
from .task import Task, TaskState


def linearize(graph: SpTaskGraph, policy: str = "fifo") -> list[Task]:
    """Total order of ``graph.tasks`` respecting the STF partial order."""
    succ = graph.successor_map()
    pred = graph.predecessor_counts(succ)
    if policy == "critical_path":
        compute_upward_ranks(graph.tasks, succ)

    counter = itertools.count()

    def key(t: Task):
        if policy == "fifo":
            return t.inserted_index
        if policy == "priority":
            return (-t.priority, t.inserted_index)
        if policy == "critical_path":
            return (-getattr(t, "_rank", 0.0), t.inserted_index)
        if policy == "overlap":
            return (0 if t.is_comm else 1, t.inserted_index)
        raise ValueError(f"unknown staged policy {policy!r}")

    heap: list = []
    for t in graph.tasks:
        if pred.get(t.uid, 0) == 0:
            heapq.heappush(heap, (key(t), next(counter), t))

    order: list[Task] = []
    done: set[int] = set()
    while heap:
        _, _, t = heapq.heappop(heap)
        if t.uid in done:  # pragma: no cover - defensive
            continue
        done.add(t.uid)
        order.append(t)
        for s in succ.get(t.uid, ()):
            pred[s.uid] -= 1
            if pred[s.uid] == 0:
                heapq.heappush(heap, (key(s), next(counter), s))
    if len(order) != len(graph.tasks):
        raise RuntimeError(
            f"linearize produced {len(order)} of {len(graph.tasks)} tasks — cycle?"
        )
    return order


def run_schedule(
    graph: SpTaskGraph,
    order: list[Task],
    impl_for: Callable[[Task], str],
) -> BaseException | None:
    """Run ``order`` sequentially with full graph bookkeeping.

    The staged executor under ``SpRuntime._flush``: each task is run with
    ``impl_for(task)`` as the preferred implementation kind, its handles
    released and its done event set, so ``wait_all_tasks`` / ``TaskView``
    work afterwards.  On the first exception the remaining not-yet-run tasks
    are marked *cancelled* (``TaskView.result()`` on them raises
    ``CancelledError``) and the error is returned, for ``result()`` /
    ``wait_all_tasks`` to raise.
    """
    error: BaseException | None = None
    for t in order:
        if t.is_done:
            continue
        if error is not None:
            t.mark_cancelled()
            graph.on_task_finished(t)
            continue
        t.state = TaskState.RUNNING
        try:
            t.run(preferred_impl=impl_for(t))
        except BaseException as e:
            t.exception = e
            error = e
        graph.on_task_finished(t)
        t.mark_finished()
    return error
