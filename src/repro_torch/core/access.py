"""Data access modes — the heart of Specx's STF (sequential task flow) model.

The paper (§4.1) defines five access modes.  A task declares, at insertion
time, how it will access each piece of data; the runtime derives the DAG from
the *sequential insertion order* plus these modes, guaranteeing that a
parallel execution is observationally identical to the sequential one.

Adaptation note: in C++ Specx a dependency is the *address* of the object.
Here the unit of dependency is an :class:`SpData` cell — a named, versioned,
mutable slot holding any Python value (tensors, dicts of tensors, ...).  Write-like accesses hand the task a :class:`SpWriteRef`
proxy (the analogue of a C++ non-const reference); reads hand the raw value
(the analogue of ``const&``).
"""
from __future__ import annotations

import enum
import itertools
from typing import Any, Iterable, Sequence


class AccessMode(enum.Enum):
    """Specx §4.1 access modes."""

    READ = "read"                 # SpRead    — concurrent with other reads
    WRITE = "write"               # SpWrite   — exclusive
    COMMUTATIVE_WRITE = "commut"  # SpCommutativeWrite — order-free, mutually exclusive
    MAYBE_WRITE = "maybe"         # SpMaybeWrite — uncertain; speculation hook
    ATOMIC_WRITE = "atomic"       # SpAtomicWrite — concurrent among themselves.
    #   NB: atomic writers run concurrently on the SAME underlying object —
    #   bodies must mutate it IN PLACE under their own lock (the C++
    #   shared-memory contract); reassigning ``ref.value`` from a stale read
    #   would lose updates, exactly as unsynchronized C++ writes would.

    @property
    def is_write_like(self) -> bool:
        return self is not AccessMode.READ


#: Group-compatibility: accesses that may share a "generation" on a handle.
#: READs run concurrently; ATOMIC_WRITEs run concurrently (user-synchronized,
#: paper: "managed very similarly to a read"); COMMUTATIVE_WRITEs share a
#: generation (order-free) but are mutually exclusive at *runtime*;
#: WRITE / MAYBE_WRITE are exclusive generations of their own.
CONCURRENT_MODES = frozenset({AccessMode.READ, AccessMode.ATOMIC_WRITE})


_data_ids = itertools.count()


class SpData:
    """A named, versioned logical buffer — the unit of dependency tracking.

    ``value`` may hold any Python value (tensors, scalars, ...).  The
    runtime never copies it except for speculation snapshots.
    """

    __slots__ = ("name", "value", "version", "uid", "last_writer", "_uncertain_writer")

    def __init__(self, value: Any = None, name: str | None = None):
        self.uid = next(_data_ids)
        self.name = name if name is not None else f"data{self.uid}"
        self.value = value
        self.version = 0
        # Worker (thread name) that last ran a write-like access on this
        # cell — the locality hint consumed by WorkStealingScheduler.push
        # (stamped by DataHandle.complete).
        self.last_writer: str | None = None
        # Set while a MAYBE_WRITE task has been inserted but whose outcome is
        # not yet known; used by the speculation pass (core/speculation.py).
        self._uncertain_writer = None

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"SpData({self.name!r}, v{self.version})"


class SpWriteRef:
    """Mutable proxy passed to task callables for write-like accesses.

    Mirrors a C++ non-const reference: ``ref.value`` reads the current
    payload; assigning ``ref.value = x`` performs the write.  For
    ``SpMaybeWrite`` accesses the runtime inspects :attr:`written` after the
    task body returns to learn whether the uncertain write actually happened
    (paper §4.6: the speculation outcome).
    """

    __slots__ = ("_value", "written", "name")

    def __init__(self, value: Any, name: str = "?"):
        self._value = value
        self.written = False
        self.name = name

    @property
    def value(self) -> Any:
        return self._value

    @value.setter
    def value(self, new: Any) -> None:
        self._value = new
        self.written = True

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"SpWriteRef({self.name!r}, written={self.written})"


class SpAccess:
    """One (data, mode) pair declared at task insertion."""

    __slots__ = ("data", "mode")

    def __init__(self, data: SpData, mode: AccessMode):
        if not isinstance(data, SpData):
            raise TypeError(
                f"Dependencies must be SpData cells, got {type(data).__name__}. "
                "Wrap your value: x = SpData(value, 'x')."
            )
        self.data = data
        self.mode = mode

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"SpAccess({self.data.name}, {self.mode.name})"


# ----------------------------------------------------------------------------
# Public constructors (paper-faithful spelling).
# ----------------------------------------------------------------------------

def SpRead(x: SpData) -> SpAccess:
    return SpAccess(x, AccessMode.READ)


def SpWrite(x: SpData) -> SpAccess:
    return SpAccess(x, AccessMode.WRITE)


def SpCommutativeWrite(x: SpData) -> SpAccess:
    return SpAccess(x, AccessMode.COMMUTATIVE_WRITE)


def SpMaybeWrite(x: SpData) -> SpAccess:
    return SpAccess(x, AccessMode.MAYBE_WRITE)


def SpAtomicWrite(x: SpData) -> SpAccess:
    return SpAccess(x, AccessMode.ATOMIC_WRITE)


# ----------------------------------------------------------------------------
# Array-of-dependencies (paper §4.1 "Dependencies on a Subset of Objects").
#
# OpenMP cannot express "depend on elements view of this vector" when the
# view is only known at runtime; Specx can.  Here the container is any
# sequence of SpData cells and ``view`` any iterable of indices.  Each
# selected element becomes its own dependency (its own handle), exactly as
# the paper describes ("Specx can iterate over the elements and apply the
# dependencies on the selected ones").
# ----------------------------------------------------------------------------

class SpArrayAccess:
    """Expands to one :class:`SpAccess` per selected element.

    The task callable receives, for this argument slot, a *list* — of raw
    values for reads, of :class:`SpWriteRef` proxies for write-like modes.
    """

    __slots__ = ("accesses",)

    def __init__(self, container: Sequence[SpData], view: Iterable[int], mode: AccessMode):
        idx = list(view)
        self.accesses = [SpAccess(container[i], mode) for i in idx]

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"SpArrayAccess({len(self.accesses)} deps)"


def SpReadArray(x: Sequence[SpData], view: Iterable[int]) -> SpArrayAccess:
    return SpArrayAccess(x, view, AccessMode.READ)


def SpWriteArray(x: Sequence[SpData], view: Iterable[int]) -> SpArrayAccess:
    return SpArrayAccess(x, view, AccessMode.WRITE)


def SpCommutativeWriteArray(x: Sequence[SpData], view: Iterable[int]) -> SpArrayAccess:
    return SpArrayAccess(x, view, AccessMode.COMMUTATIVE_WRITE)


def SpMaybeWriteArray(x: Sequence[SpData], view: Iterable[int]) -> SpArrayAccess:
    return SpArrayAccess(x, view, AccessMode.MAYBE_WRITE)


def SpAtomicWriteArray(x: Sequence[SpData], view: Iterable[int]) -> SpArrayAccess:
    return SpArrayAccess(x, view, AccessMode.ATOMIC_WRITE)


class SpPriority:
    """Task priority hint (paper §4.1): the scheduler is free to use it."""

    __slots__ = ("value",)

    def __init__(self, value: int):
        self.value = int(value)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"SpPriority({self.value})"


# ----------------------------------------------------------------------------
# Per-processing-unit callables (paper §4.3).  ``SpCpu``/``SpCuda`` become
# implementation *variants*: SpRef (plain PyTorch), SpCuda (a hand-written
# CUDA kernel), SpHost (python-only, e.g. I/O or checkpoint commit).  The
# scheduler or a capability probe picks among them.
# ----------------------------------------------------------------------------

class SpImpl:
    __slots__ = ("fn", "kind")

    def __init__(self, fn, kind: str):
        self.fn = fn
        self.kind = kind


def SpRef(fn) -> SpImpl:
    """Reference implementation — plain PyTorch; runs anywhere."""
    return SpImpl(fn, "ref")


def SpCuda(fn) -> SpImpl:
    """CUDA kernel implementation (kind ``"cuda"``)."""
    return SpImpl(fn, "cuda")


def SpHost(fn) -> SpImpl:
    """Host/python implementation (I/O, checkpoint commit, ...)."""
    return SpImpl(fn, "host")


# Paper-compatible aliases: SpCpu ≙ the reference path, SpCuda / SpHip ≙
# the device-kernel path (kind ``"cuda"``).
SpCpu = SpRef
SpHip = SpCuda
