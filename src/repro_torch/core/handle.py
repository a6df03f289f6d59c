"""Data handles and dependency generations (paper §4.7 internals).

Specx keeps one *data handle* per address used as a dependency; the handle
owns the ordered list of accesses applied to the object.  "In terms of
implementation, we do not construct a graph; instead we have one data handle
per address ... when a task is finished, we increment a counter on the
dependency list and access the next tasks."  We reproduce that design:

* one :class:`DataHandle` per :class:`SpData` cell (keyed by ``id`` — note
  Keying on logical cells removes the paper's
  same-address-reuse undefined behaviour);
* each handle holds a list of :class:`Generation` — maximal runs of
  group-compatible accesses (all-READ, all-ATOMIC, all-COMMUTATIVE, or a
  single WRITE / MAYBE_WRITE);
* a task is *ready* when every one of its accesses sits in the currently
  active generation of its handle;
* when a generation completes, the next generation activates and its tasks'
  pending counters decrement — the counter walk from the paper.

Commutative writes: members of a COMMUTATIVE generation are all *released*
together (order-free) but must be mutually exclusive at runtime; the engine
acquires :attr:`DataHandle.commutative_lock` (multi-handle acquisition in
sorted-uid order — the paper's deadlock-avoidance-by-address-sort).
"""
from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Optional

from .access import AccessMode, CONCURRENT_MODES, SpData

if TYPE_CHECKING:  # pragma: no cover
    from .task import Task


def _compatible(kind: AccessMode, mode: AccessMode) -> bool:
    """May ``mode`` join a generation whose kind is ``kind``?"""
    if kind in CONCURRENT_MODES and mode in CONCURRENT_MODES and kind is mode:
        return True
    if kind is AccessMode.COMMUTATIVE_WRITE and mode is AccessMode.COMMUTATIVE_WRITE:
        return True
    return False


class Generation:
    """One maximal run of group-compatible accesses on a handle."""

    __slots__ = ("kind", "tasks", "done", "active")

    def __init__(self, kind: AccessMode):
        self.kind = kind
        self.tasks: list["Task"] = []
        self.done = 0
        self.active = False

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"Gen({self.kind.name}, {self.done}/{len(self.tasks)},"
            f" {'active' if self.active else 'pending'})"
        )


class DataHandle:
    """Per-SpData dependency bookkeeping."""

    __slots__ = ("data", "generations", "cursor", "commutative_lock", "lock")

    def __init__(self, data: SpData):
        self.data = data
        self.generations: list[Generation] = []
        self.cursor = 0  # index of the active generation
        # runtime mutual exclusion for commutative writers (paper §4.7)
        self.commutative_lock = threading.Lock()
        # protects generation bookkeeping
        self.lock = threading.Lock()

    # -- insertion-time (single inserter thread; STF) -------------------------

    def append_access(self, task: "Task", mode: AccessMode) -> bool:
        """Record ``task``'s access.  Returns True iff the access lands in the
        currently active generation (i.e. does not block readiness).

        Insertion happens on the single STF inserter thread, but workers may
        concurrently :meth:`complete` earlier generations — hence the lock.
        """
        with self.lock:
            gens = self.generations
            if gens and _compatible(gens[-1].kind, mode) and gens[-1].done == 0:
                gen = gens[-1]
            else:
                gen = Generation(mode)
                gens.append(gen)
                if len(gens) - 1 == self.cursor:
                    gen.active = True
            gen.tasks.append(task)
            return gen.active

    # -- run-time --------------------------------------------------------------

    def complete(self, task: "Task") -> list["Task"]:
        """Mark ``task``'s access on this handle complete.

        Returns the list of tasks whose pending counters were decremented to
        zero *by this handle* (newly ready tasks).  Thread-safe.
        """
        newly_ready: list["Task"] = []
        with self.lock:
            gen = self.generations[self.cursor]
            gen.done += 1
            if gen.kind.is_write_like and task.worker_name is not None:
                # locality hint consumed by WorkStealingScheduler.push
                self.data.last_writer = task.worker_name
            if gen.done < len(gen.tasks):
                return newly_ready
            # generation finished → bump data version for write-like gens
            if gen.kind.is_write_like:
                self.data.version += 1
            self.cursor += 1
            if self.cursor < len(self.generations):
                nxt = self.generations[self.cursor]
                nxt.active = True
                for t in nxt.tasks:
                    if t.dec_pending():
                        newly_ready.append(t)
        return newly_ready

    @property
    def active_generation(self) -> Optional[Generation]:
        if self.cursor < len(self.generations):
            return self.generations[self.cursor]
        return None


class HandleRegistry:
    """id(SpData) → DataHandle map (the paper's address-keyed hashmap)."""

    __slots__ = ("_handles",)

    def __init__(self):
        self._handles: dict[int, DataHandle] = {}

    def handle_for(self, data: SpData) -> DataHandle:
        h = self._handles.get(id(data))
        if h is None:
            h = DataHandle(data)
            self._handles[id(data)] = h
        return h

    def maybe_handle(self, data: SpData) -> Optional[DataHandle]:
        return self._handles.get(id(data))

    def __iter__(self):
        return iter(self._handles.values())

    def __len__(self) -> int:
        return len(self._handles)
