"""``SpTaskGraph`` — STF task insertion and dependency resolution (paper §4.1).

A single thread inserts tasks, declaring data accesses; the graph derives
the DAG (via per-handle generations, see ``handle.py``) and guarantees the
parallel execution matches the sequential insertion order.  The graph is
dissociated from the compute engine (paper §4.2): bind one with
:meth:`compute_on`; tasks that became ready earlier are buffered.

Speculative execution (paper §4.6) is enabled by constructing the graph with
``SpSpeculativeModel.SP_MODEL_1`` — see ``speculation.py``.
"""
from __future__ import annotations

import enum
import threading
from typing import Any, Optional, Sequence

from .access import (
    AccessMode,
    SpAccess,
    SpArrayAccess,
    SpData,
    SpImpl,
    SpPriority,
)
from .handle import HandleRegistry
from .task import Task, TaskView, normalize_impls


class SpSpeculativeModel(enum.Enum):
    SP_NO_SPEC = 0
    SP_MODEL_1 = 1  # speculate past the most recent uncertain writer
    SP_MODEL_2 = 2  # speculate past whole CHAINS of uncertain writers:
    #                 one snapshot before the first writer; readers overlap
    #                 the entire chain and roll back if ANY writer wrote


class SpTaskGraph:
    """Task graph with STF semantics.

    Example (mirrors paper Code 2)::

        tg = SpTaskGraph()
        a, b = SpData(1.0, "a"), SpData(2.0, "b")
        view = tg.task(SpRead(a), SpWrite(b), lambda a_v, b_ref: b_ref.__setattr__("value", a_v + b_ref.value))
        tg.compute_on(engine)
        tg.wait_all_tasks()
    """

    def __init__(
        self,
        speculative_model: SpSpeculativeModel = SpSpeculativeModel.SP_NO_SPEC,
        *,
        trace: bool = True,
    ):
        self.spec_model = speculative_model
        self.registry = HandleRegistry()
        self.tasks: list[Task] = []
        self._task_by_uid: dict[int, Task] = {}
        self.engine = None  # SpComputeEngine once bound
        self._ready_backlog: list[Task] = []
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._unfinished = 0
        self.errors: list[BaseException] = []
        # poison tasks parked by the failure policy: their errors
        # do NOT surface through wait_all_tasks — the graph stays alive,
        # dependents are cancelled, and engine.stop() reports them by name
        self.quarantined: list[Task] = []
        # trace events appended by the engine: dicts with task/worker/t0/t1.
        # ``trace=False`` turns recording off so the production hot path
        # allocates nothing per task; exports then see an empty trace.
        self.trace = trace
        self.trace_events: list[dict] = []
        self.spec_stats = {"speculated": 0, "commits": 0, "rollbacks": 0}
        # set by a staged SpRuntime (core/api.py): zero-arg callable that
        # executes the pending graph; TaskView.result() triggers it
        self._flush_hook = None

    # ------------------------------------------------------------------ insert

    def task(
        self,
        *args,
        name: str | None = None,
        cost: float = 1.0,
        priority: int = 0,
        comm: bool = False,
    ) -> TaskView:
        """Insert a task.  Positional args may be, in any order:
        ``SpPriority``, ``SpAccess`` / ``SpArrayAccess`` (argument slots, in
        declaration order), and one or more callables / ``SpImpl`` variants.

        ``comm=True`` marks a communication task: the eager engine routes it
        to the background comm thread only when it carries a ``comm_start``
        (see comm.py); in the staged backend the flag steers the ``overlap``
        linearization policy (collectives issued as early as possible).

        This positional spelling is the compatibility form; the declarative
        codelet frontend (``repro_torch.core.api``) inserts through the same
        :meth:`insert_task` path.
        """
        prio = priority
        accesses: list[SpAccess] = []
        arg_layout: list[tuple[str, Any]] = []
        impl_raw: list = []
        for a in args:
            if isinstance(a, SpPriority):
                prio = a.value
            elif isinstance(a, SpAccess):
                accesses.append(a)
                arg_layout.append(("single", a))
            elif isinstance(a, SpArrayAccess):
                accesses.extend(a.accesses)
                arg_layout.append(("array", a.accesses))
            elif isinstance(a, SpImpl) or callable(a):
                impl_raw.append(a)
            else:
                raise TypeError(f"unsupported task() argument: {a!r}")
        impls = normalize_impls(impl_raw)
        return self.insert_task(
            impls, accesses, arg_layout, priority=prio, name=name, cost=cost, comm=comm
        )

    def insert_task(
        self,
        impls: dict,
        accesses: Sequence[SpAccess],
        arg_layout: Sequence[tuple[str, Any]],
        *,
        priority: int = 0,
        name: str | None = None,
        cost: float = 1.0,
        comm: bool = False,
    ) -> TaskView:
        """Insert a fully-resolved task (impl dict + accesses + argument
        layout).  Shared lower half of :meth:`task` and the codelet frontend
        — runs the speculation pass, then wires dependencies."""
        self._check_duplicate_handles(accesses)

        if self.spec_model is not SpSpeculativeModel.SP_NO_SPEC:
            from .speculation import maybe_speculative_insert

            view = maybe_speculative_insert(
                self, impls, list(accesses), list(arg_layout), priority, name, cost
            )
            if view is not None:
                return view

        task = Task(impls, accesses, arg_layout, priority, name, cost=cost, is_comm=comm)
        return self._insert(task)

    def _check_duplicate_handles(self, accesses: Sequence[SpAccess]) -> None:
        seen: set[int] = set()
        for acc in accesses:
            if acc.data.uid in seen:
                raise ValueError(
                    f"task declares {acc.data.name!r} twice; merge the accesses"
                )
            seen.add(acc.data.uid)

    def _insert(self, task: Task) -> TaskView:
        """Wire dependencies and dispatch if ready.  Internal: speculation and
        comm layers call this to bypass re-speculation."""
        task.inserted_index = len(self.tasks)
        task.graph = self
        self.tasks.append(task)
        self._task_by_uid[task.uid] = task
        with self._cv:
            self._unfinished += 1

        # Insertion guard: keeps ``pending`` above zero until every access is
        # wired, so a worker completing a predecessor generation mid-insert
        # cannot mark the task ready prematurely.
        task.add_pending(1)
        commutative = []
        for acc in task.accesses:
            h = self.registry.handle_for(acc.data)
            if acc.mode is AccessMode.COMMUTATIVE_WRITE:
                commutative.append(h)
            task.add_pending(1)
            if h.append_access(task, acc.mode):
                # landed in the already-active generation
                task.dec_pending()
        if commutative:
            # sorted-uid lock order (paper §4.7 deadlock freedom), fixed
            # here once so the engine never re-derives it per execution
            commutative.sort(key=lambda h: h.data.uid)
            task.commutative_handles = tuple(commutative)
        if task.dec_pending():  # drop the guard
            self._dispatch(task)
        return TaskView(task)

    # ------------------------------------------------------------------ engine

    def _dispatch(self, task: Task) -> None:
        if self.engine is not None:
            self.engine.push_task(task)
        else:
            with self._lock:
                self._ready_backlog.append(task)

    def compute_on(self, engine) -> "SpTaskGraph":
        """Bind a compute engine (paper §4.2 ``tg.computeOn(ce)``)."""
        self.engine = engine
        engine.register_graph(self)
        with self._lock:
            backlog, self._ready_backlog = self._ready_backlog, []
        for t in backlog:
            engine.push_task(t)
        return self

    computeOn = compute_on

    # ------------------------------------------------------------- completion

    def on_task_finished(self, task: Task) -> list[Task]:
        """Release ``task``'s dependencies; return newly ready tasks."""
        newly: list[Task] = []
        for acc in task.accesses:
            h = self.registry.maybe_handle(acc.data)
            if h is not None:
                newly.extend(h.complete(task))
        with self._cv:
            self._unfinished -= 1
            if task.exception is not None and not task.quarantined:
                self.errors.append(task.exception)
            self._cv.notify_all()
        return newly

    # ----------------------------------------------------- failure policies

    def quarantine(self, task: Task) -> None:
        """Park ``task`` as poison (``on_failure="quarantine"``):
        its exception stays off the error list (``wait_all_tasks`` keeps
        working), its transitive dependents are poisoned so the engine
        cancels them with ``CancelledError`` instead of running them on
        garbage inputs, and sibling branches proceed untouched.  Call
        *before* :meth:`on_task_finished` releases the dependents."""
        task.quarantined = True
        with self._cv:
            if task not in self.quarantined:
                self.quarantined.append(task)
        self.poison_dependents(task)

    def poison_dependents(self, task: Task) -> None:
        """Mark every transitive dependent inserted so far as poisoned.
        Poisoned tasks are cancelled by the engine when they become ready —
        the marking must happen before the failed task's dependencies are
        released, so no dependent can slip through the race window."""
        succ = self.successor_map()
        stack = list(succ.get(task.uid, []))
        seen: set[int] = set()
        while stack:
            t = stack.pop()
            if t.uid in seen or t.is_done:
                continue
            seen.add(t.uid)
            t.poisoned = True
            stack.extend(succ.get(t.uid, []))

    def wait_all_tasks(self, timeout: float | None = None, raise_errors: bool = True) -> None:
        with self._cv:
            ok = self._cv.wait_for(lambda: self._unfinished == 0, timeout)
        if not ok:
            raise TimeoutError(
                f"wait_all_tasks timed out with {self._unfinished} unfinished tasks"
            )
        if raise_errors and self.errors:
            raise self.errors[0]

    waitAllTasks = wait_all_tasks

    @property
    def unfinished(self) -> int:
        return self._unfinished

    # ------------------------------------------------------------- structure

    def successor_map(self) -> dict[int, list[Task]]:
        """uid → successor tasks, derived from handle generations."""
        succ: dict[int, list[Task]] = {}
        for h in self.registry:
            gens = h.generations
            for gi in range(len(gens) - 1):
                for t in gens[gi].tasks:
                    succ.setdefault(t.uid, []).extend(gens[gi + 1].tasks)
        # dedupe, preserve order
        for k, v in succ.items():
            seen: set[int] = set()
            out = []
            for t in v:
                if t.uid not in seen:
                    seen.add(t.uid)
                    out.append(t)
            succ[k] = out
        return succ

    def task_by_uid(self, uid: int) -> Task:
        """O(1) uid → task lookup (index maintained by :meth:`_insert`)."""
        return self._task_by_uid[uid]

    def predecessor_counts(self, succ: dict[int, list[Task]] | None = None) -> dict[int, int]:
        """uid → number of predecessors.  Pass an existing ``successor_map()``
        to avoid rebuilding it (O(V+E) either way)."""
        if succ is None:
            succ = self.successor_map()
        pred: dict[int, int] = {t.uid: 0 for t in self.tasks}
        for _, vs in succ.items():
            for v in vs:
                pred[v.uid] = pred.get(v.uid, 0) + 1
        return pred

    def edges(self) -> list[tuple[Task, Task]]:
        out = []
        by_uid = self._task_by_uid
        for u, vs in self.successor_map().items():
            src = by_uid[u]
            for v in vs:
                out.append((src, v))
        return out

    # --------------------------------------------------------------- exports

    def generate_dot(self, path: str, *, show_accesses: bool = False) -> str:
        from .dot import graph_to_dot

        text = graph_to_dot(self, show_accesses=show_accesses)
        with open(path, "w") as f:
            f.write(text)
        return text

    generateDot = generate_dot

    def generate_trace(self, path: str, show_dependencies: bool = True) -> str:
        from .trace import trace_to_svg

        text = trace_to_svg(self, show_dependencies=show_dependencies)
        with open(path, "w") as f:
            f.write(text)
        return text

    generateTrace = generate_trace


# NB: SpRuntime (paper Code 1) lives in ``core/api.py``.
