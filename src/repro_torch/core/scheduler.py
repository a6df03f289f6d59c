"""Pluggable schedulers (paper §4.5).

Specx adopts StarPU's two-function contract: ``push(task)`` when a task
becomes ready, ``pop(worker)`` when a worker is available.  New schedulers
are classes deriving from :class:`SpAbstractScheduler` — no runtime changes
needed (the paper's explicit design goal).

Shipped policies:

* :class:`FifoScheduler` — the paper's default.
* :class:`LifoScheduler` — depth-first; better cache reuse on chains.
* :class:`PriorityScheduler` — honors :class:`~repro_torch.core.access.SpPriority`.
* :class:`CriticalPathScheduler` — HEFT-flavoured: pops the ready task with
  the longest downstream cost (upward rank); ranks are computed by
  :func:`compute_upward_ranks` over the finished graph (in eager streaming
  mode it degrades gracefully to priority order).
* :class:`WorkStealingScheduler` — per-worker deques with locality-aware
  pushes and randomized stealing (see below).

Scheduling policies & locality
------------------------------

Paper §4.5 deliberately leaves the placement policy open ("the scheduler is
free to use it").  Our work-stealing policy fills that gap the way StarPU's
``dmda``-family and Heteroflow's per-worker queues do — by making the
*common* case lock-cheap and data-local, and the *rare* case (stealing)
correct:

* **One deque per registered worker, one lock per deque.**  ``push`` and
  ``pop`` touch only the deque they operate on; there is no global lock on
  the hot path (a small registration lock guards worker attach/detach only).
* **Locality push.**  Every :class:`~repro_torch.core.handle.DataHandle` records
  the worker that last ran a write-like access on its
  :class:`~repro_torch.core.access.SpData` (``data.last_writer``, stamped on
  generation completion).  ``push`` tallies the last writers of a ready
  task's accesses and routes the task to the deque of the *dominant* input's
  last writer — the worker most likely to still hold that data warm.  Tasks
  with no usable hint fall back to the least-loaded deque.
* **Owner-LIFO / thief-FIFO.**  Owners pop newest-first (depth-first, warm
  caches); thieves steal oldest-first (breadth-first, coarse work).
* **Steal order.**  An idle worker first drains the *overflow* deque (tasks
  orphaned by worker detach — never left to languish behind random victim
  choice), then retries the victim it last stole from successfully, then
  scans the remaining deques in randomized order.
* **Counters.**  ``stats()`` exposes push/pop/steal/locality counters.
"""
from __future__ import annotations

import collections
import heapq
import itertools
import random
import threading
from typing import Optional

from .task import Task


class SpAbstractScheduler:
    """Interface: push / pop / __len__.  Implementations must be thread-safe
    (the engine calls them under its own condition variable, but requeues and
    multi-graph use can interleave)."""

    def push(self, task: Task) -> Optional[str]:
        """Queue a ready task.  May return the name of the worker whose
        deque received it (the engine then unparks that worker); policies
        without per-worker queues return None."""
        raise NotImplementedError

    def pop(self, worker_kind: str = "ref") -> Optional[Task]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class FifoScheduler(SpAbstractScheduler):
    """First-in-first-out — Specx's current default (paper §4.5)."""

    def __init__(self):
        self._q: collections.deque[Task] = collections.deque()
        self._lock = threading.Lock()

    def push(self, task: Task) -> None:
        with self._lock:
            self._q.append(task)

    def pop(self, worker_kind: str = "ref") -> Optional[Task]:
        with self._lock:
            return self._q.popleft() if self._q else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


class LifoScheduler(SpAbstractScheduler):
    def __init__(self):
        self._q: collections.deque[Task] = collections.deque()
        self._lock = threading.Lock()

    def push(self, task: Task) -> None:
        with self._lock:
            self._q.append(task)

    def pop(self, worker_kind: str = "ref") -> Optional[Task]:
        with self._lock:
            return self._q.pop() if self._q else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


class PriorityScheduler(SpAbstractScheduler):
    """Max-heap on ``task.priority``; FIFO among equal priorities."""

    def __init__(self):
        self._heap: list[tuple[int, int, Task]] = []
        self._lock = threading.Lock()
        self._counter = itertools.count()

    def push(self, task: Task) -> None:
        with self._lock:
            heapq.heappush(self._heap, (-task.priority, next(self._counter), task))

    def pop(self, worker_kind: str = "ref") -> Optional[Task]:
        with self._lock:
            if not self._heap:
                return None
            return heapq.heappop(self._heap)[2]

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)


class CriticalPathScheduler(PriorityScheduler):
    """Pops by upward rank when available (``task._rank``), else priority.

    Use :func:`compute_upward_ranks` once the graph is fully inserted to fill
    ranks; in streaming mode unranked tasks fall back to their priority.
    """

    def push(self, task: Task) -> None:
        rank = getattr(task, "_rank", None)
        key = rank if rank is not None else float(task.priority)
        with self._lock:
            heapq.heappush(self._heap, (-key, next(self._counter), task))


class _WorkerDeque:
    """A worker's run queue: its own lock so push/pop never serialize
    scheduler-wide.  ``closed`` marks a deque whose worker detached mid-push
    (the pusher re-routes; see :meth:`WorkStealingScheduler.push`)."""

    __slots__ = ("q", "lock", "closed")

    def __init__(self):
        self.q: collections.deque[Task] = collections.deque()
        self.lock = threading.Lock()
        self.closed = False


class WorkStealingScheduler(SpAbstractScheduler):
    """Per-worker deques; owner pops LIFO, thieves steal FIFO.

    The engine registers each attached worker (by thread name) via
    :meth:`register_worker`.  ``push`` routes a ready task to the deque of
    its dominant input's last writer (``locality=True``, the default; see
    the module docstring), falling back to the least-loaded deque.  Before
    any worker is registered (or after all detach) tasks land in an
    overflow deque that idle poppers drain *before* stealing.
    """

    _OVERFLOW = "w0"

    def __init__(self, seed: int = 0, locality: bool = True):
        self._locality = locality
        # _reg_lock guards membership (register/unregister); the hot path
        # reads the _workers snapshot and _deques entries without it.
        self._reg_lock = threading.Lock()
        self._workers: tuple[str, ...] = ()
        self._overflow_dq = _WorkerDeque()
        self._deques: dict[str, _WorkerDeque] = {self._OVERFLOW: self._overflow_dq}
        self._rr = itertools.count()  # probe cursor for hint-less pushes
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self._last_victim: dict[str, str] = {}
        # hot-path counters are plain ints bumped without a lock: a lost
        # increment under GIL interleaving is harmless for monitoring, and
        # the hot path stays lock-free outside the deque ops themselves
        self._pushes = 0
        self._locality_hits = 0   # pushed onto the last-writer's own deque
        self._pops_local = 0      # owner popped its own deque
        self._pops_overflow = 0   # drained an orphaned task
        self._steals = 0          # popped from another worker's deque
        self._failed_pops = 0     # found nothing anywhere

    # ------------------------------------------------------------ membership

    def register_worker(self, worker_name: str) -> None:
        with self._reg_lock:
            if worker_name not in self._workers:
                dq = self._deques.get(worker_name)
                if dq is None or dq.closed:
                    self._deques[worker_name] = _WorkerDeque()
                self._workers = self._workers + (worker_name,)

    def unregister_worker(self, worker_name: str) -> None:
        """Detach a worker; its unfinished tasks move to the overflow deque."""
        if worker_name == self._OVERFLOW:
            return
        with self._reg_lock:
            self._workers = tuple(w for w in self._workers if w != worker_name)
            dq = self._deques.pop(worker_name, None)
            if dq is None:
                return
            overflow = self._deques[self._OVERFLOW]
            # lock order: victim deque then overflow — nothing else ever
            # holds two deque locks, so this cannot deadlock
            with dq.lock:
                dq.closed = True
                orphans = list(dq.q)
                dq.q.clear()
            if orphans:
                with overflow.lock:
                    overflow.q.extend(orphans)

    # ------------------------------------------------------------------ push

    def _locality_owner(self, task: Task) -> Optional[str]:
        """Dominant input's last writer, if it is a registered worker.
        Single-access tasks are resolved inline in :meth:`push`; this handles
        the multi-access vote."""
        tally: dict[str, int] = {}
        for acc in task.accesses:
            w = acc.data.last_writer
            if w is not None:
                tally[w] = tally.get(w, 0) + 1
        if not tally:
            return None
        workers = self._workers
        best = None
        best_n = 0
        for w, n in tally.items():
            if n > best_n and w in workers:
                best, best_n = w, n
        return best

    def push(self, task: Task) -> Optional[str]:
        """Queue a ready task; returns the deque (worker name) it landed on
        so the engine can unpark that specific worker."""
        owner = None
        if self._locality:
            accesses = task.accesses
            if len(accesses) == 1:  # inline fast path: 1-access tasks
                w = accesses[0].data.last_writer
                if w is not None and w in self._workers:
                    owner = w
            else:
                owner = self._locality_owner(task)
        hit = owner is not None
        while True:
            if owner is None:
                workers = self._workers
                n = len(workers)
                if n == 0:
                    owner = self._OVERFLOW
                elif n == 1:
                    owner = workers[0]
                else:
                    # hint-less fallback: power-of-two-choices — probe two
                    # deques and take the shorter (near-least-loaded balance
                    # at O(1) cost instead of a full scan per push)
                    i = next(self._rr)
                    a = workers[i % n]
                    b = workers[(i + 1 + (i >> 3)) % n]
                    da, db = self._deques.get(a), self._deques.get(b)
                    la = len(da.q) if da is not None else 1 << 30
                    lb = len(db.q) if db is not None else 1 << 30
                    owner = a if la <= lb else b
            dq = self._deques.get(owner)
            if dq is None:
                owner = self._OVERFLOW
                continue
            with dq.lock:
                if not dq.closed:
                    dq.q.append(task)
                    break
            owner = None  # raced with unregister — re-route
        self._pushes += 1
        if hit:
            self._locality_hits += 1
        return owner

    # ------------------------------------------------------------------- pop

    def _try_pop(self, name: str, lifo: bool) -> Optional[Task]:
        dq = self._deques.get(name)
        if dq is None or not dq.q:
            return None
        with dq.lock:
            if not dq.q:
                return None
            return dq.q.pop() if lifo else dq.q.popleft()

    def pop(self, worker_kind: str = "ref", worker_name: str = "w0") -> Optional[Task]:
        # 1. own deque, newest-first (warm caches) — inlined hot path
        dq = self._deques.get(worker_name)
        if dq is not None and dq.q:
            with dq.lock:
                if dq.q:
                    self._pops_local += 1
                    return dq.q.pop()
        # 2. orphaned work first — overflow never waits on victim luck
        ov = self._overflow_dq
        if ov.q and worker_name != self._OVERFLOW:
            with ov.lock:
                if ov.q:
                    self._pops_overflow += 1
                    return ov.q.popleft()
        # 3. last successful victim, then a scan from a random start point
        #    (cheaper than a full shuffle, same anti-convoy effect); steal
        #    oldest-first
        last = self._last_victim.get(worker_name)
        if last is not None:
            t = self._try_pop(last, lifo=False)
            if t is not None:
                self._steals += 1
                return t
        # list(dict) snapshots atomically; iterating the live dict would race
        # with register/unregister mutating it from other threads
        candidates = [
            v for v in list(self._deques) if v not in (worker_name, self._OVERFLOW, last)
        ]
        if candidates:
            with self._rng_lock:
                start = self._rng.randrange(len(candidates))
            for i in range(len(candidates)):
                victim = candidates[(start + i) % len(candidates)]
                t = self._try_pop(victim, lifo=False)
                if t is not None:
                    self._last_victim[worker_name] = victim
                    self._steals += 1
                    return t
        self._failed_pops += 1
        return None

    def __len__(self) -> int:
        # snapshot sum — len(deque) is atomic; exactness is not required here
        return sum(len(d.q) for d in list(self._deques.values()))

    def stats(self) -> dict:
        out = {
            "pushes": self._pushes,
            "locality_hits": self._locality_hits,
            "pops_local": self._pops_local,
            "pops_overflow": self._pops_overflow,
            "steals": self._steals,
            "failed_pops": self._failed_pops,
            "queued": len(self),
        }
        pops = out["pops_local"] + out["pops_overflow"] + out["steals"]
        out["local_hit_rate"] = out["pops_local"] / pops if pops else 0.0
        out["steal_rate"] = out["steals"] / pops if pops else 0.0
        out["locality_push_rate"] = (
            out["locality_hits"] / out["pushes"] if out["pushes"] else 0.0
        )
        return out


def compute_upward_ranks(tasks: list[Task], successors: dict[int, list[Task]]) -> None:
    """HEFT upward rank: rank(t) = cost(t) + max over successors of rank(s).

    ``successors`` maps task uid → successor tasks (derivable from the graph
    via :meth:`SpTaskGraph.successor_map`).  Sets ``task._rank`` in place.
    """
    memo: dict[int, float] = {}

    order = list(tasks)
    # iterative reverse-topological accumulation (tasks are inserted in a
    # valid topological order by STF construction, so reverse insertion
    # order is a valid reverse-topological order)
    for t in sorted(order, key=lambda x: x.inserted_index, reverse=True):
        succ = successors.get(t.uid, ())
        best = 0.0
        for s in succ:
            best = max(best, memo.get(s.uid, 0.0))
        memo[t.uid] = t.cost + best
        t._rank = memo[t.uid]


SCHEDULERS = {
    "fifo": FifoScheduler,
    "lifo": LifoScheduler,
    "priority": PriorityScheduler,
    "critical_path": CriticalPathScheduler,
    "work_stealing": WorkStealingScheduler,
}


def make_scheduler(name: str, **kw) -> SpAbstractScheduler:
    try:
        return SCHEDULERS[name](**kw)
    except KeyError:
        raise ValueError(f"unknown scheduler {name!r}; have {sorted(SCHEDULERS)}") from None
