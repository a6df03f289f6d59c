"""Compute engines and teams of workers (paper §4.2).

A :class:`SpComputeEngine` owns a team of workers (threads).  Each worker
continuously pops tasks from the engine's (pluggable) scheduler and executes
them.  Engines may drive several task graphs; workers can be *moved between
engines at runtime* ("dynamically adjust the capabilities of the compute
engine during execution", paper §4.2).

Worker *kinds* replace CPU-vs-GPU workers.  A ``ref`` worker prefers the
plain PyTorch implementation of a task, a ``cuda`` worker prefers the CUDA
kernel implementation (falling back to ``ref`` where the kernel's probe
fails), a ``host`` worker is meant for I/O-ish tasks.  Any worker may launch
CUDA work from its thread: launches go to that thread's current stream.

Communication tasks never run on workers: a dedicated background thread
starts non-blocking operations and polls for completion, releasing
dependencies as early as possible (paper §4.4) — see ``comm.py``.
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import CancelledError
from typing import Optional

from .scheduler import FifoScheduler, SpAbstractScheduler, WorkStealingScheduler
from .task import SpTaskTimeoutError, Task, TaskState


class SpWorker(threading.Thread):
    _ids = iter(range(1 << 30))

    def __init__(self, engine: "SpComputeEngine", kind: str = "ref"):
        self.wid = next(SpWorker._ids)
        super().__init__(name=f"spworker-{self.wid}", daemon=True)
        self.kind = kind
        self.engine = engine
        self.target_engine: Optional["SpComputeEngine"] = None  # pending move
        self.alive = True
        # per-worker parking spot: the engine sets this to hand the worker
        # new work / a stop / a move, instead of broadcasting on one global
        # condition variable (paper §4.2 workers are individually addressable)
        self.wakeup = threading.Event()

    def run(self) -> None:  # pragma: no branch - loop
        while self.alive:
            eng = self.engine
            if self.target_engine is not None:
                new_eng = self.target_engine
                self.target_engine = None
                eng._detach_worker(self)
                new_eng._attach_worker(self)
                continue
            task = eng._next_task(self)
            if task is None:
                continue  # woke for stop/move
            eng._execute(task, self)

    def retire(self) -> None:
        self.alive = False


class SpWorkerTeam:
    """A collection of workers assignable to compute engines."""

    def __init__(self, kinds: list[str]):
        self.kinds = kinds

    def __len__(self) -> int:
        return len(self.kinds)


class SpWorkerTeamBuilder:
    """Paper-spelling builders (Code 5)."""

    @staticmethod
    def default_num_threads() -> int:
        return max(2, min(8, os.cpu_count() or 2))

    DefaultNumThreads = default_num_threads

    @staticmethod
    def team_of_cpu_workers(n: int | None = None) -> SpWorkerTeam:
        n = n or SpWorkerTeamBuilder.default_num_threads()
        return SpWorkerTeam(["ref"] * n)

    TeamOfCpuWorkers = team_of_cpu_workers

    @staticmethod
    def team_of_cpu_cuda_workers(n_cpu: int | None = None, n_dev: int = 1) -> SpWorkerTeam:
        """Mixed team: ``ref`` workers + ``cuda`` (device-kernel) workers."""
        n_cpu = n_cpu or SpWorkerTeamBuilder.default_num_threads()
        return SpWorkerTeam(["ref"] * n_cpu + ["cuda"] * n_dev)

    TeamOfCpuCudaWorkers = team_of_cpu_cuda_workers


class _Watchdog(threading.Thread):
    """Hung-task monitor.  Workers arm a deadline per attempt of a
    policy-timed task; on expiry the engine fails the task with
    :class:`SpTaskTimeoutError` and completes it *externally* — the worker
    thread stuck in the body becomes a discarded zombie and
    ``wait_all_tasks`` never wedges on it.  Lazily started on the first
    timed task, so untimed workloads pay nothing."""

    _ids = iter(range(1 << 20))

    def __init__(self, engine: "SpComputeEngine"):
        super().__init__(name=f"spwatchdog-{next(_Watchdog._ids)}", daemon=True)
        self.engine = engine
        self._lock = threading.Lock()
        self._armed: dict[Task, float] = {}
        self._kick = threading.Event()
        self._running = True

    def arm(self, task: Task, deadline: float) -> None:
        with self._lock:
            self._armed[task] = deadline
        self._kick.set()  # re-evaluate the sleep against the new deadline

    def disarm(self, task: Task) -> None:
        with self._lock:
            self._armed.pop(task, None)

    def stop(self) -> None:
        self._running = False
        self._kick.set()

    def run(self) -> None:
        while self._running:
            now = time.monotonic()
            expired: list[Task] = []
            nxt: Optional[float] = None
            with self._lock:
                for t, d in list(self._armed.items()):
                    if d <= now:
                        expired.append(t)
                        del self._armed[t]
                    elif nxt is None or d < nxt:
                        nxt = d
            for t in expired:
                self.engine._fail_hung_task(t)
            self._kick.clear()
            wait = 0.05 if nxt is None else min(0.05, max(0.0005, nxt - time.monotonic()))
            self._kick.wait(wait)


class SpComputeEngine:
    def __init__(
        self,
        team: SpWorkerTeam | None = None,
        scheduler: SpAbstractScheduler | None = None,
        name: str = "ce",
    ):
        self.name = name
        # NB: ``scheduler or Fifo...`` would be wrong — schedulers define
        # __len__, so a freshly-created (empty) scheduler is falsy and would
        # be silently swapped for FIFO
        self.scheduler = scheduler if scheduler is not None else FifoScheduler()
        # per-worker-deque schedulers take the popping worker's name
        self._pop_by_name = isinstance(self.scheduler, WorkStealingScheduler)
        # engine-structure lock (worker list, graph list) — NOT on the
        # push/pop hot path; the scheduler carries its own locking and idle
        # workers park on their own events (see _next_task)
        self._lock = threading.Lock()
        self._idle_lock = threading.Lock()
        self._idle: list[SpWorker] = []  # LIFO: most-recently-parked first
        self._running = True
        self._workers: list[SpWorker] = []
        self._graphs: list = []
        self._comm = None  # lazily created CommThread (comm.py)
        self._wd: Optional[_Watchdog] = None  # lazily created hung-task monitor
        self._stop_report: list[str] | None = None  # set by the first stop()
        if team is None:  # (SpWorkerTeam also defines __len__ — same trap)
            team = SpWorkerTeamBuilder.team_of_cpu_workers()
        for kind in team.kinds:
            w = SpWorker(self, kind)
            self._workers.append(w)
            self._register_with_scheduler(w)
            w.start()

    def _register_with_scheduler(self, w: SpWorker) -> None:
        reg = getattr(self.scheduler, "register_worker", None)
        if reg is not None:
            reg(w.name)

    def _unregister_from_scheduler(self, w: SpWorker) -> None:
        unreg = getattr(self.scheduler, "unregister_worker", None)
        if unreg is not None:
            unreg(w.name)

    # ------------------------------------------------------------- graph API

    def register_graph(self, graph) -> None:
        with self._lock:
            if graph not in self._graphs:
                self._graphs.append(graph)

    @staticmethod
    def _is_async_comm(task: Task) -> bool:
        # only tasks with a non-blocking start protocol go to the comm
        # thread; comm-*flagged* compute tasks (staged scheduling hints)
        # run on normal workers
        return task.is_comm and hasattr(task, "comm_start")

    def push_task(self, task: Task) -> None:
        if self._is_async_comm(task):
            self._comm_thread().submit(task)
            return
        owner = self.scheduler.push(task)
        self._wake_one(owner)

    def push_many(self, tasks: list[Task]) -> None:
        if not tasks:
            return
        owners = []
        for t in tasks:
            if self._is_async_comm(t):
                self._comm_thread().submit(t)
            else:
                owners.append(self.scheduler.push(t))
        for owner in owners:
            if not self._wake_one(owner):
                break  # nobody parked; workers will find the tasks on poll

    # ------------------------------------------------------------ worker side

    def _wake_one(self, owner: Optional[str] = None) -> bool:
        """Unpark one idle worker — preferably ``owner``, the worker whose
        deque just received the task (locality-aware schedulers return it
        from ``push``)."""
        if not self._idle:  # lock-free fast path; parking workers re-check
            return False    # the scheduler before waiting, so a miss here
            #                 costs at most one bounded backoff timeout
        with self._idle_lock:
            w = None
            if owner is not None:
                for i, cand in enumerate(self._idle):
                    if cand.name == owner:
                        w = self._idle.pop(i)
                        break
            if w is None and self._idle:
                w = self._idle.pop()
        if w is not None:
            w.wakeup.set()
            return True
        return False

    # Idle wait: ~1 ms first park doubling to 50 ms.  The timeout is a
    # safety net — pushes normally unpark a worker explicitly — so the cap
    # bounds worst-case dispatch latency when a wake is missed (the old
    # fixed poll burned a 100 ms round trip on EVERY dispatch race).
    _BACKOFF_MIN = 0.001
    _BACKOFF_MAX = 0.05

    def _pop(self, worker: SpWorker) -> Optional[Task]:
        if self._pop_by_name:
            return self.scheduler.pop(worker.kind, worker.name)
        return self.scheduler.pop(worker.kind)

    def _next_task(self, worker: SpWorker) -> Optional[Task]:
        backoff = self._BACKOFF_MIN
        while self._running and worker.alive and worker.target_engine is None:
            t = self._pop(worker)
            if t is not None:
                # if more work is queued and someone is parked, chain-wake so
                # a burst push fans out even when only one wake landed (the
                # unlocked _idle peek keeps this free at steady state)
                if self._idle and len(self.scheduler) > 0:
                    self._wake_one()
                return t
            # park: register as idle *before* the re-check so a concurrent
            # push either sees us on the idle list or we see its task
            worker.wakeup.clear()
            with self._idle_lock:
                self._idle.append(worker)
            t = self._pop(worker)
            if t is not None:
                with self._idle_lock:
                    if worker in self._idle:
                        self._idle.remove(worker)
                return t
            worker.wakeup.wait(timeout=backoff)
            with self._idle_lock:
                if worker in self._idle:
                    self._idle.remove(worker)
            backoff = min(backoff * 2.0, self._BACKOFF_MAX)
        return None

    def _execute(self, task: Task, worker: SpWorker) -> None:
        graph = getattr(task, "graph", None)
        if task.poisoned:
            # a quarantined/timed-out predecessor: its output never
            # materialized, so running this task would propagate garbage —
            # cancel instead (waiters see CancelledError)
            task.mark_cancelled()
            if graph is not None:
                self.push_many(graph.on_task_finished(task))
            return
        token = getattr(task, "cancel_token", None)
        if token is not None and token.is_set():
            on_cancel = getattr(task, "on_cancel", None)
            if on_cancel is not None:
                try:
                    on_cancel(task)
                except BaseException as e:  # pragma: no cover - defensive
                    task.exception = e
            task.mark_cancelled()
            if graph is not None:
                self.push_many(graph.on_task_finished(task))
            return

        # paper §4.7: commutative accesses require runtime mutual exclusion;
        # handles were sorted by uid at insert (deadlock freedom), so the hot
        # path just walks the precomputed tuple
        locks = [h.commutative_lock for h in task.commutative_handles]
        for lk in locks:
            lk.acquire()
        policy = task.policy
        watched = policy is not None and policy.timeout is not None
        task.state = TaskState.RUNNING
        task.worker_name = worker.name
        task.t_start = time.perf_counter()
        try:
            attempt = 0
            while True:
                if watched:
                    self._watchdog().arm(task, time.monotonic() + policy.timeout)
                try:
                    task.run(preferred_impl=worker.kind)
                    task.exception = None
                    break
                except BaseException as e:
                    task.exception = e
                finally:
                    if watched:
                        self._watchdog().disarm(task)
                if task.timed_out:
                    break  # the watchdog already failed + completed the task
                attempt += 1
                if (
                    policy is None
                    or attempt > policy.retries
                    or isinstance(task.exception, CancelledError)
                    or not self._running
                ):
                    break
                # retry: fresh write-refs are rebuilt by run(); a raising
                # body never reached its writebacks, so inputs are intact
                task.retries_used = attempt
                task.exception = None
                if policy.retry_backoff > 0.0:
                    time.sleep(policy.retry_backoff * (2 ** (attempt - 1)))
        finally:
            task.t_end = time.perf_counter()
            for lk in reversed(locks):
                lk.release()
        if watched and not task.claim_completion():
            return  # zombie return: the watchdog completed this task
        if token is not None:
            if task.exception is None:
                token.set(task)
            else:
                # a crashed replica must not win the race: park the error on
                # the token (surfaced by the select task only if every copy
                # fails) and let the healthy copies keep going
                record = getattr(token, "record_failure", None)
                if record is not None:
                    record(task.exception)
                    task.exception = None
        if graph is not None:
            if getattr(graph, "trace", True):
                graph.trace_events.append(
                    {
                        "task": task.name,
                        "uid": task.uid,
                        "worker": worker.name,
                        "t0": task.t_start,
                        "t1": task.t_end,
                        "ready": len(self.scheduler),
                        "comm": task.is_comm,
                        "spec": task.speculative,
                    }
                )
            if (
                task.exception is not None
                and policy is not None
                and policy.on_failure == "quarantine"
            ):
                # poison-task containment: park the error off the graph's
                # error list and cancel dependents (before their release)
                graph.quarantine(task)
            newly = graph.on_task_finished(task)
            task.mark_finished()
            self.push_many(newly)
        else:  # pragma: no cover - tasks always carry a graph backref
            task.mark_finished()

    # --------------------------------------------------------------- watchdog

    def _watchdog(self) -> _Watchdog:
        if self._wd is None:
            with self._lock:
                if self._wd is None:
                    wd = _Watchdog(self)
                    wd.start()
                    self._wd = wd
        return self._wd

    def _fail_hung_task(self, task: Task) -> None:
        """Watchdog expiry: fail ``task`` with :class:`SpTaskTimeoutError`
        and complete it while the worker is still stuck inside the body.
        The zombie's eventual return is discarded (completion claim +
        writeback guard in ``Task.run``).  Timeouts are terminal — no retry:
        the zombie may still be mutating whatever wedged it."""
        task.timed_out = True
        if not task.claim_completion():
            return  # the worker finished inside the race window
        policy = task.policy
        task.exception = SpTaskTimeoutError(
            f"task {task.name!r} exceeded its {policy.timeout}s timeout "
            f"(watchdog); the hung body is abandoned as a zombie"
        )
        graph = getattr(task, "graph", None)
        if graph is None:  # pragma: no cover - tasks always carry a graph
            task.mark_finished()
            return
        if policy.on_failure == "quarantine":
            graph.quarantine(task)
        else:
            # even on "raise", dependents must not run on garbage inputs
            graph.poison_dependents(task)
        newly = graph.on_task_finished(task)
        task.mark_finished()
        self.push_many(newly)

    # ------------------------------------------------------------- team mgmt

    @property
    def n_workers(self) -> int:
        return len(self._workers)

    def _attach_worker(self, w: SpWorker) -> None:
        with self._lock:
            self._workers.append(w)
            w.engine = self
            self._register_with_scheduler(w)

    def _detach_worker(self, w: SpWorker) -> None:
        with self._lock:
            if w in self._workers:
                self._workers.remove(w)
            self._unregister_from_scheduler(w)
        with self._idle_lock:
            if w in self._idle:
                self._idle.remove(w)
        # orphans may have been drained to the scheduler's overflow deque —
        # make sure somebody looks at them
        self._wake_one()

    def add_workers(self, n: int, kind: str = "ref") -> None:
        for _ in range(n):
            w = SpWorker(self, kind)
            with self._lock:
                self._workers.append(w)
                self._register_with_scheduler(w)
            w.start()

    def send_workers_to(self, other: "SpComputeEngine", n: int) -> int:
        """Move up to ``n`` workers to ``other`` (paper §4.2 dynamic teams)."""
        moved = []
        with self._lock:
            movable = [w for w in self._workers if w.target_engine is None]
            for w in movable[:n]:
                w.target_engine = other
                moved.append(w)
        for w in moved:  # unpark so the move is taken promptly
            w.wakeup.set()
        return len(moved)

    # ------------------------------------------------------------------ comm

    def _comm_thread(self):
        if self._comm is None:
            from .comm import CommThread

            self._comm = CommThread(self)
            self._comm.start()
        return self._comm

    # ------------------------------------------------------------------ stop

    def _drain_cancel_leftovers(self) -> int:
        """Cancel tasks still queued after the workers are gone — work
        pushed in the stop() race window (or released by the comm thread's
        grace period) would otherwise strand ``wait_all_tasks`` forever.
        Successors released by the cancellations are cancelled too."""
        stack: list[Task] = []
        while True:
            if self._pop_by_name:
                t = self.scheduler.pop("ref", "__drain__")
            else:
                t = self.scheduler.pop("ref")
            if t is None:
                break
            stack.append(t)
        n = 0
        while stack:
            t = stack.pop()
            if t.is_done:  # pragma: no cover - raced with a live worker
                continue
            t.mark_cancelled()
            n += 1
            graph = getattr(t, "graph", None)
            if graph is not None:
                stack.extend(graph.on_task_finished(t))
        return n

    def stop(self) -> list[str]:
        """Stop workers, then the comm thread, then cancel any stranded
        queued tasks.  Returns the names of comm tasks whose requests had
        to be aborted (empty in a clean shutdown) plus the names of tasks
        quarantined by their failure policy; aborted tasks carry an
        ``SpCommAbortedError`` so their waiters see a real error instead of
        hanging on a leaked daemon thread.

        Idempotent: a second call (recovery path + ``atexit``, or an
        explicit ``stop()`` followed by ``__exit__``) returns the first
        call's report without re-joining threads or re-cancelling tasks."""
        with self._lock:
            if self._stop_report is not None:
                return list(self._stop_report)
            self._running = False
            workers = list(self._workers)
            for w in workers:
                w.alive = False
        for w in workers:
            w.wakeup.set()
        me = threading.current_thread()
        for w in workers:
            if w is not me:
                w.join(timeout=5.0)
        aborted: list[str] = []
        if self._comm is not None:
            aborted = self._comm.stop()
        if self._wd is not None:
            self._wd.stop()
        self._drain_cancel_leftovers()
        report = aborted + [
            t.name for g in self._graphs for t in getattr(g, "quarantined", ())
        ]
        with self._lock:
            self._stop_report = list(report)
        return report

    stopIfNotAlreadyStopped = stop

    def __enter__(self) -> "SpComputeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
