"""Tasks and task viewers (paper §4.1, §4.3).

A task owns: its access list, a priority, one callable per implementation
kind (``ref`` / ``cuda`` / ``host`` — the SpCpu/SpCuda adaptation), and
bookkeeping for readiness, execution and tracing.

Calling convention: the callable receives one argument per
declared access, in declaration order — the raw value for ``SpRead``, an
:class:`~repro_torch.core.access.SpWriteRef` proxy for write-like modes, and a
list thereof for ``Sp*Array`` accesses.  The callable's return value is the
task's *result* (paper: "getting the value produced by the task"),
independent of the writes — mirroring C++ reference semantics.
"""
from __future__ import annotations

import itertools
import threading
from concurrent.futures import CancelledError
from typing import Any, Callable, Optional, Sequence

from .access import AccessMode, SpAccess, SpImpl, SpWriteRef

_task_ids = itertools.count()


class SpTaskTimeoutError(TimeoutError):
    """A task exceeded its policy ``timeout`` and was failed by the engine's
    watchdog.  The worker thread that ran it may still be stuck inside the
    body (a *zombie*): its eventual return is discarded — no result, no
    writebacks — so the graph's view of the data stays consistent."""


class SpTaskPolicy:
    """Per-task robustness policy: stamped on a :class:`Task` by
    the codelet frontend (``@sp_task(retries=..., timeout=...)``) and
    enforced by the eager engine.

    * ``retries`` — re-run the body up to this many extra times when it
      raises (``CancelledError`` and watchdog timeouts are terminal).
    * ``retry_backoff`` — sleep ``retry_backoff * 2**(attempt-1)`` seconds
      between attempts.
    * ``timeout`` — wall-clock budget per attempt; on expiry the watchdog
      fails the task with :class:`SpTaskTimeoutError` while the hung body
      keeps running as a discarded zombie.
    * ``on_failure`` — what a *terminal* failure does to the graph:
      ``"raise"`` parks the error for ``wait_all_tasks`` (the default);
      ``"retry"`` is the same after the retry budget is spent (the spelling
      implied by ``retries>0``); ``"quarantine"`` records the task on
      ``graph.quarantined``, cancels its dependents with ``CancelledError``
      and keeps the graph alive — poison tasks no longer wedge the run.
    """

    __slots__ = ("retries", "retry_backoff", "timeout", "on_failure")

    MODES = ("raise", "retry", "quarantine")

    def __init__(
        self,
        retries: int = 0,
        retry_backoff: float = 0.0,
        timeout: float | None = None,
        on_failure: str | None = None,
    ):
        if on_failure is None:
            on_failure = "retry" if retries else "raise"
        if on_failure not in self.MODES:
            raise ValueError(
                f"on_failure must be one of {self.MODES}, got {on_failure!r}"
            )
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        if timeout is not None and timeout <= 0:
            raise ValueError(f"timeout must be positive, got {timeout}")
        self.retries = int(retries)
        self.retry_backoff = float(retry_backoff)
        self.timeout = timeout
        self.on_failure = on_failure

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"SpTaskPolicy(retries={self.retries}, "
            f"retry_backoff={self.retry_backoff}, timeout={self.timeout}, "
            f"on_failure={self.on_failure!r})"
        )


class TaskState:
    NOT_READY = "not-ready"
    READY = "ready"
    RUNNING = "running"
    FINISHED = "finished"
    CANCELLED = "cancelled"  # straggler-mitigation loser


class Task:
    """Internal task object.  Users interact through :class:`TaskView`."""

    def __init__(
        self,
        impls: dict[str, Callable],
        accesses: Sequence[SpAccess],
        arg_layout: Sequence[tuple[str, Any]],
        priority: int = 0,
        name: str | None = None,
        *,
        is_comm: bool = False,
        cost: float = 1.0,
        speculative: bool = False,
    ):
        self.uid = next(_task_ids)
        self.name = name or f"task{self.uid}"
        self.impls = impls  # kind -> callable
        self.accesses = list(accesses)
        # arg_layout: how to build callable arguments: list of
        # ("single", SpAccess) | ("array", [SpAccess, ...]) in declaration order
        self.arg_layout = list(arg_layout)
        self.priority = priority
        self.is_comm = is_comm
        self.cost = cost  # scheduler cost estimate (CriticalPath)
        self.speculative = speculative

        self.state = TaskState.NOT_READY
        self.pending = 0  # number of handle-generations not yet active
        self._pending_lock = threading.Lock()
        self.result: Any = None
        self.exception: BaseException | None = None
        self._done_event = threading.Event()
        # trace metadata
        self.worker_name: str | None = None
        self.t_start: float = 0.0
        self.t_end: float = 0.0
        # maybe-write outcomes, filled after execution: SpData uid -> bool
        self.maybe_written: dict[int, bool] = {}
        # successors cache for dot export (filled lazily by graph)
        self.inserted_index: int = -1
        # commutative-write handles in sorted-uid order, precomputed at
        # insert (graph._insert) so the engine hot path takes no per-task
        # detour through the registry (paper §4.7 runtime mutual exclusion)
        self.commutative_handles: tuple = ()
        # codelet-frontend metadata (core/api.py): the hidden cell holding
        # the body's return value (enables TaskView.then chaining) and the
        # platform-preferred impl kind resolved at bind time
        self.result_cell = None
        self.preferred_kind: str | None = None
        # robustness policy: enforced by the eager engine
        self.policy: SpTaskPolicy | None = None
        self.retries_used = 0
        self.timed_out = False  # set by the watchdog; the body is a zombie
        self.quarantined = False
        self.poisoned = False  # a quarantined/timed-out predecessor: cancel
        self._completion_claimed = False

    # -- readiness bookkeeping --------------------------------------------------

    def add_pending(self, n: int = 1) -> None:
        with self._pending_lock:
            self.pending += n

    def dec_pending(self) -> bool:
        """Decrement; return True when the task just became ready."""
        with self._pending_lock:
            self.pending -= 1
            ready = self.pending == 0 and self.state == TaskState.NOT_READY
            if ready:
                self.state = TaskState.READY
            return ready

    # -- execution ---------------------------------------------------------------

    def pick_impl(self, preferred: str = "ref") -> Callable:
        if preferred in self.impls:
            return self.impls[preferred]
        if "ref" in self.impls:
            return self.impls["ref"]
        raise KeyError(
            f"task {self.name!r} has no {preferred!r} implementation and no "
            f"'ref' fallback; registered kinds: {sorted(self.impls)}"
        )

    def build_args(self) -> tuple[list, list[tuple[SpAccess, SpWriteRef]]]:
        """Materialize callable arguments.  Returns (args, writebacks)."""
        args: list = []
        writebacks: list[tuple[SpAccess, SpWriteRef]] = []
        for kind, payload in self.arg_layout:
            if kind == "single":
                acc: SpAccess = payload
                if acc.mode is AccessMode.READ:
                    args.append(acc.data.value)
                else:
                    ref = SpWriteRef(acc.data.value, acc.data.name)
                    writebacks.append((acc, ref))
                    args.append(ref)
            else:  # "array"
                sub_args = []
                for acc in payload:
                    if acc.mode is AccessMode.READ:
                        sub_args.append(acc.data.value)
                    else:
                        ref = SpWriteRef(acc.data.value, acc.data.name)
                        writebacks.append((acc, ref))
                        sub_args.append(ref)
                args.append(sub_args)
        return args, writebacks

    def claim_completion(self) -> bool:
        """First caller wins the right to complete this task.  Arbitrates
        the race between the executing worker and the engine watchdog: a
        timed-out task is completed by the watchdog, and the zombie worker's
        eventual return must not complete it a second time."""
        with self._pending_lock:
            if self._completion_claimed:
                return False
            self._completion_claimed = True
            return True

    def run(self, preferred_impl: str = "ref") -> None:
        """Execute the task body and write back results.  No dependency
        release here — the engine/graph drives that."""
        fn = self.pick_impl(preferred_impl)
        args, writebacks = self.build_args()
        out = fn(*args)
        if self.timed_out:
            # the watchdog already failed this task and released its
            # dependents; a zombie's late result/writebacks would clobber
            # data that successors (or a re-submitted step) now own
            return
        self.result = out
        for acc, ref in writebacks:
            if acc.mode is AccessMode.MAYBE_WRITE:
                self.maybe_written[acc.data.uid] = ref.written
                if ref.written:
                    acc.data.value = ref.value
            else:
                # WRITE / COMMUTATIVE / ATOMIC: adopt the proxy value.  If the
                # body never assigned, the value is unchanged (identity write).
                acc.data.value = ref.value

    def mark_finished(self) -> None:
        self.state = TaskState.FINISHED
        self._done_event.set()

    def mark_cancelled(self) -> None:
        self.state = TaskState.CANCELLED
        self._done_event.set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._done_event.wait(timeout)

    @property
    def is_done(self) -> bool:
        return self._done_event.is_set()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Task({self.name!r}, {self.state}, prio={self.priority})"


class TaskView:
    """User-facing viewer (paper §4.1 "Task Viewer") with a future-like API.

    Allows naming the task, waiting for completion and fetching the produced
    value (``get_value`` — paper spelling — or the concurrent.futures-style
    :meth:`result` / :meth:`done` / :meth:`exception`), and chaining
    follow-up work with :meth:`then`.  On a staged runtime, asking for the
    result forces the pending graph to execute (the graph's flush hook).
    The paper notes the pitfall that names may be set after execution —
    unchanged here, and equally harmless.
    """

    __slots__ = ("_task",)

    def __init__(self, task: Task):
        self._task = task

    def set_task_name(self, name: str) -> "TaskView":
        self._task.name = name
        return self

    # C++ API spelling
    setTaskName = set_task_name

    def get_task_name(self) -> str:
        return self._task.name

    def wait(self, timeout: float | None = None) -> bool:
        ok = self._task.wait(timeout)
        if self._task.exception is not None:
            raise self._task.exception
        return ok

    def get_value(self) -> Any:
        self.wait()
        return self._task.result

    getValue = get_value

    # -- future-like API (codelet frontend, core/api.py) ---------------------

    def done(self) -> bool:
        return self._task.is_done

    def _maybe_flush(self) -> None:
        """On a staged runtime the graph only executes when flushed; asking
        for a result is such a trigger (SpRuntime installs the hook)."""
        if self._task.is_done:
            return
        hook = getattr(getattr(self._task, "graph", None), "_flush_hook", None)
        if hook is not None:
            hook()

    def result(self, timeout: float | None = None) -> Any:
        """Block until done; raise the task's exception (or CancelledError —
        concurrent.futures semantics) or return its value."""
        self._maybe_flush()
        if not self._task.wait(timeout):
            raise TimeoutError(f"task {self._task.name!r} still pending")
        if self._task.exception is not None:
            self._mark_error_observed()
            raise self._task.exception
        if self._task.state == TaskState.CANCELLED:
            raise CancelledError(f"task {self._task.name!r} was cancelled")
        return self._task.result

    def exception(self, timeout: float | None = None) -> BaseException | None:
        self._maybe_flush()
        if not self._task.wait(timeout):
            raise TimeoutError(f"task {self._task.name!r} still pending")
        if self._task.exception is not None:
            self._mark_error_observed()
            return self._task.exception
        if self._task.state == TaskState.CANCELLED:
            raise CancelledError(f"task {self._task.name!r} was cancelled")
        return None

    def _mark_error_observed(self) -> None:
        """An exception delivered through the future API counts as handled:
        drop it from the graph's error list so wait_all_tasks / scope exit
        does not re-raise what the caller already saw."""
        graph = getattr(self._task, "graph", None)
        if graph is not None:
            try:
                graph.errors.remove(self._task.exception)
            except ValueError:
                pass

    def then(self, fn, *, name: str | None = None, cost: float = 1.0) -> "TaskView":
        """Chain ``fn`` over this task's result: inserts a follow-up task
        reading the hidden result cell (so the dependency is ordinary data
        flow, honored by both backends) and returns its view."""
        task = self._task
        cell = getattr(task, "result_cell", None)
        graph = getattr(task, "graph", None)
        if cell is None or graph is None:
            raise RuntimeError(
                "then() requires a task inserted through the codelet frontend "
                "(sp_task / SpCodelet), which records a result cell; a "
                "result=False (fire-and-forget) call has none — chain off a "
                "written cell instead"
            )
        from .access import AccessMode, SpAccess, SpData

        nm = name or f"{task.name}.then"
        out = SpData(None, f"{nm}.result")
        in_acc = SpAccess(cell, AccessMode.READ)
        out_acc = SpAccess(out, AccessMode.WRITE)

        def body(v, res_ref):
            r = fn(v)
            res_ref.value = r
            return r

        view = graph.insert_task(
            {"ref": body},
            [in_acc, out_acc],
            [("single", in_acc), ("single", out_acc)],
            name=nm,
            cost=cost,
        )
        view.task.result_cell = out
        return view

    @property
    def state(self) -> str:
        return self._task.state

    @property
    def task(self) -> Task:
        return self._task

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"TaskView({self._task.name!r}, {self._task.state})"


def normalize_impls(raw: Sequence) -> dict[str, Callable]:
    """Accept bare callables (→ ref) and SpImpl wrappers."""
    impls: dict[str, Callable] = {}
    for item in raw:
        if isinstance(item, SpImpl):
            impls[item.kind] = item.fn
        elif callable(item):
            impls.setdefault("ref", item)
        else:  # pragma: no cover - defensive
            raise TypeError(f"not a callable or SpImpl: {item!r}")
    if not impls:
        raise ValueError("task needs at least one callable")
    return impls
