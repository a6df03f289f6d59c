"""Codelet frontend — declare a task once, run it anywhere (paper §4.1, §4.3).

Specx's headline API idea is that a task is *declared* with its access modes
and carries multiple implementations (``SpCpu`` / ``SpCuda``) among which the
runtime selects per processing unit — StarPU's codelets, adapted.  This
module is that frontend for the PyTorch port:

* :func:`sp_task` — a decorator that turns a plain function into a reusable
  :class:`SpCodelet` with *named argument slots*::

      @sp_task(read=("a",), write=("b",))
      def axpy(a, b, *, alpha=2.0):
          b.value = b.value + alpha * a

  or, equivalently, with typed annotations (``SpRead`` / ``SpWrite`` /
  ``SpCommutativeWrite`` / ``SpMaybeWrite`` / ``SpAtomicWrite``)::

      @sp_task
      def axpy(a: SpRead, b: SpWrite, *, alpha=2.0): ...

  Parameters not named in an access spec are *static parameters*, partially
  applied at call time (``axpy(a_cell, b_cell, alpha=3.0)``).

* :meth:`SpCodelet.impl` — register additional implementation variants with
  capability predicates (the SpCpu/SpCuda selection from the paper)::

      @axpy.impl("cuda", available=cuda_available)
      def _(a, b, *, alpha=2.0): ...

  At *call* time the codelet keeps only the variants whose ``available()``
  probe passes; the executing worker's kind picks among them, and the
  ``cuda`` kind is preferred where it is available.

* :class:`SpRuntime` — one entry point over both execution backends.  The
  same user code runs threaded-eager or staged by flipping one argument::

      with SpRuntime(backend="eager", workers=4) as rt:   # or backend="staged"
          view = axpy(a_cell, b_cell)
          print(view.result())

  ``SpRuntime(elastic=True)`` survives rank death: see its docstring.

  The runtime is a context manager; inside its scope (or an explicit
  :func:`graph_scope`) codelet calls insert tasks into the current graph and
  return future-like :class:`~repro.core.task.TaskView` objects
  (``result()`` / ``done()`` / ``exception()`` / ``then()``).

The positional ``tg.task(SpRead(a), SpWrite(b), fn)`` spelling remains as a
compatibility shim over the same insertion path (``SpTaskGraph.insert_task``).
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import inspect
import time
from typing import Any, Callable, Optional, Sequence

from .access import (
    AccessMode,
    SpAccess,
    SpAtomicWrite,
    SpCommutativeWrite,
    SpData,
    SpMaybeWrite,
    SpRead,
    SpWrite,
)
from .graph import SpSpeculativeModel, SpTaskGraph
from .task import SpTaskPolicy, TaskView

# ---------------------------------------------------------------------------
# Current-graph scope.
# ---------------------------------------------------------------------------

_scope: contextvars.ContextVar[Optional[SpTaskGraph]] = contextvars.ContextVar(
    "sp_graph_scope", default=None
)


def current_graph() -> Optional[SpTaskGraph]:
    """The innermost active graph scope (None outside any scope)."""
    return _scope.get()


@contextlib.contextmanager
def graph_scope(graph: SpTaskGraph):
    """Make ``graph`` the insertion target for codelet calls in the block."""
    token = _scope.set(graph)
    try:
        yield graph
    finally:
        _scope.reset(token)


# ---------------------------------------------------------------------------
# Slot declaration.
# ---------------------------------------------------------------------------

class SpSlot:
    """One named argument slot of a codelet: (parameter name, access mode)."""

    __slots__ = ("name", "mode")

    def __init__(self, name: str, mode: AccessMode):
        self.name = name
        self.mode = mode

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"SpSlot({self.name!r}, {self.mode.name})"


#: Annotation spellings accepted by the bare-decorator form.  The access
#: constructors themselves double as type markers; strings cover modules with
#: ``from __future__ import annotations`` (where annotations are strings).
_ANNOTATION_MODES: dict[Any, AccessMode] = {
    SpRead: AccessMode.READ,
    SpWrite: AccessMode.WRITE,
    SpCommutativeWrite: AccessMode.COMMUTATIVE_WRITE,
    SpMaybeWrite: AccessMode.MAYBE_WRITE,
    SpAtomicWrite: AccessMode.ATOMIC_WRITE,
    "SpRead": AccessMode.READ,
    "SpWrite": AccessMode.WRITE,
    "SpCommutativeWrite": AccessMode.COMMUTATIVE_WRITE,
    "SpMaybeWrite": AccessMode.MAYBE_WRITE,
    "SpAtomicWrite": AccessMode.ATOMIC_WRITE,
    "read": AccessMode.READ,
    "write": AccessMode.WRITE,
    "commutative": AccessMode.COMMUTATIVE_WRITE,
    "maybe": AccessMode.MAYBE_WRITE,
    "atomic": AccessMode.ATOMIC_WRITE,
}

for _mode in AccessMode:
    _ANNOTATION_MODES[_mode] = _mode


def _mode_from_annotation(ann: Any) -> Optional[AccessMode]:
    if ann is inspect.Parameter.empty:
        return None
    if isinstance(ann, str):
        ann = ann.strip()
    try:
        return _ANNOTATION_MODES.get(ann)
    except TypeError:  # unhashable annotation
        return None


def _as_names(spec) -> tuple[str, ...]:
    if spec is None:
        return ()
    if isinstance(spec, str):
        return (spec,)
    return tuple(spec)


def _positional_params(fn: Callable) -> list[inspect.Parameter]:
    sig = inspect.signature(fn)
    return [
        p
        for p in sig.parameters.values()
        if p.kind
        in (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
    ]


def _build_slots(
    fn: Callable,
    read,
    write,
    commutative,
    maybe,
    atomic,
) -> tuple[list[SpSlot], set[str], bool]:
    """Derive (slots-in-signature-order, static parameter names, has **kwargs)."""
    mode_of: dict[str, AccessMode] = {}
    for names, mode in (
        (read, AccessMode.READ),
        (write, AccessMode.WRITE),
        (commutative, AccessMode.COMMUTATIVE_WRITE),
        (maybe, AccessMode.MAYBE_WRITE),
        (atomic, AccessMode.ATOMIC_WRITE),
    ):
        for n in _as_names(names):
            if n in mode_of:
                raise ValueError(f"parameter {n!r} declared under two access modes")
            mode_of[n] = mode

    params = _positional_params(fn)
    slots: list[SpSlot] = []
    if mode_of:
        by_name = {p.name for p in params}
        unknown = [n for n in mode_of if n not in by_name]
        if unknown:
            raise ValueError(
                f"access spec names {unknown} are not positional parameters of "
                f"{getattr(fn, '__name__', fn)!r}"
            )
        slots = [SpSlot(p.name, mode_of[p.name]) for p in params if p.name in mode_of]
    else:
        for p in params:
            mode = _mode_from_annotation(p.annotation)
            if mode is not None:
                slots.append(SpSlot(p.name, mode))
        if not slots:
            raise ValueError(
                f"codelet {getattr(fn, '__name__', fn)!r} declares no data slots; "
                "pass read=/write=/... or annotate parameters with SpRead/SpWrite/..."
            )

    slot_names = {s.name for s in slots}
    sig = inspect.signature(fn)
    static = {
        p.name
        for p in sig.parameters.values()
        if p.name not in slot_names
        and p.kind
        not in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
    }
    has_var_kw = any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()
    )
    return slots, static, has_var_kw


# ---------------------------------------------------------------------------
# The codelet.
# ---------------------------------------------------------------------------

class SpCodelet:
    """A reusable task declaration: named slots + one impl per kind.

    Built by :func:`sp_task`; additional implementation variants register
    through :meth:`impl`.  Calling the codelet binds :class:`SpData` cells
    (or sequences of cells — an array slot) to the slots and inserts one
    task into the current graph scope, returning its :class:`TaskView`.
    """

    #: call-time keywords reserved for the runtime (never static params)
    RESERVED = (
        "graph", "name", "priority", "cost", "result",
        "retries", "retry_backoff", "timeout", "on_failure",
    )

    def __init__(
        self,
        fn: Callable,
        slots: Sequence[SpSlot],
        *,
        static: set[str],
        has_var_kw: bool = False,
        name: str | None = None,
        cost: float = 1.0,
        priority: int = 0,
        comm: bool = False,
        policy: SpTaskPolicy | None = None,
        result: bool = True,
    ):
        self.name = name or getattr(fn, "__name__", "codelet")
        self.slots = list(slots)
        self.cost = cost
        self.priority = priority
        self.comm = comm
        self.result = result  # declare-time default for the hidden result cell
        self.policy = policy  # default robustness policy for inserted tasks
        self.__doc__ = getattr(fn, "__doc__", None)
        self._static = set(static)
        self._has_var_kw = has_var_kw
        # kind -> (callable, availability predicate or None)
        self._impls: dict[str, tuple[Callable, Optional[Callable[[], bool]]]] = {
            "ref": (fn, None)
        }

    # ------------------------------------------------------------ registration

    def impl(self, kind: str, fn: Callable | None = None, *, available=None):
        """Register an implementation variant for ``kind``.

        Usable as a decorator (``@cl.impl("cuda", available=probe)``) or
        directly (``cl.impl("host", host_fn)``).  ``available`` is a zero-arg
        capability probe evaluated at *call* time; an unavailable variant is
        excluded from that call's dispatch table.
        """

        def register(f: Callable):
            self._impls[kind] = (f, available)
            return f

        if fn is not None:
            register(fn)
            return self
        return register

    @property
    def impl_kinds(self) -> list[str]:
        """Registered implementation kinds (regardless of availability)."""
        return sorted(self._impls)

    def available_kinds(self) -> list[str]:
        """Kinds whose capability probe passes right now."""
        return sorted(
            kind
            for kind, (_, avail) in self._impls.items()
            if avail is None or avail()
        )

    # --------------------------------------------------------------- insertion

    def __call__(self, *args, **kwargs) -> TaskView:
        graph = kwargs.pop("graph", None)
        if graph is None:
            graph = current_graph()
        if graph is None:
            raise RuntimeError(
                f"codelet {self.name!r} called outside a graph scope; enter an "
                "SpRuntime (`with SpRuntime(...)`) or graph_scope(tg), or pass "
                "graph=<SpTaskGraph>"
            )
        name = kwargs.pop("name", None) or self.name
        priority = kwargs.pop("priority", self.priority)
        cost = kwargs.pop("cost", self.cost)
        want_result = bool(kwargs.pop("result", self.result))
        # per-call robustness overrides; default to the codelet's
        # declared policy
        policy = self.policy
        if any(k in kwargs for k in ("retries", "retry_backoff", "timeout", "on_failure")):
            base = policy
            policy = SpTaskPolicy(
                retries=kwargs.pop(
                    "retries", base.retries if base is not None else 0
                ),
                retry_backoff=kwargs.pop(
                    "retry_backoff", base.retry_backoff if base is not None else 0.0
                ),
                timeout=kwargs.pop(
                    "timeout", base.timeout if base is not None else None
                ),
                on_failure=kwargs.pop(
                    "on_failure", base.on_failure if base is not None else None
                ),
            )

        # -- bind slots (positional first, then by name) ---------------------
        if len(args) > len(self.slots):
            raise TypeError(
                f"{self.name} takes {len(self.slots)} data slots, got "
                f"{len(args)} positional arguments"
            )
        bound: dict[str, Any] = {}
        for slot, val in zip(self.slots, args):
            bound[slot.name] = val
        for slot in self.slots:
            if slot.name in kwargs:
                if slot.name in bound:
                    raise TypeError(f"{self.name}: slot {slot.name!r} bound twice")
                bound[slot.name] = kwargs.pop(slot.name)
        missing = [s.name for s in self.slots if s.name not in bound]
        if missing:
            raise TypeError(f"{self.name}: missing data slots {missing}")

        static = kwargs  # everything left over is a static parameter
        if not self._has_var_kw:
            unknown = sorted(set(static) - self._static)
            if unknown:
                raise TypeError(
                    f"{self.name}: unknown static parameters {unknown}; "
                    f"declared: {sorted(self._static)} "
                    f"(reserved call keywords: {list(self.RESERVED)})"
                )

        # -- build accesses / argument layout --------------------------------
        accesses: list[SpAccess] = []
        arg_layout: list[tuple[str, Any]] = []
        for slot in self.slots:
            val = bound[slot.name]
            if isinstance(val, SpData):
                acc = SpAccess(val, slot.mode)
                accesses.append(acc)
                arg_layout.append(("single", acc))
            elif isinstance(val, (list, tuple)):
                accs = [SpAccess(v, slot.mode) for v in val]
                accesses.extend(accs)
                arg_layout.append(("array", accs))
            else:
                raise TypeError(
                    f"{self.name}: slot {slot.name!r} takes an SpData cell or a "
                    f"sequence of cells, got {type(val).__name__}. "
                    f"Wrap your value: x = SpData(value, {slot.name!r})."
                )
        result_cell = None
        if want_result:
            # the hidden result cell .then()/.result() chaining hangs off;
            # fire-and-forget calls (result=False) skip the cell, its WRITE
            # access, and the per-call SpData allocation entirely
            result_cell = SpData(None, f"{name}.result")
            res_acc = SpAccess(result_cell, AccessMode.WRITE)
            accesses.append(res_acc)
            arg_layout.append(("single", res_acc))

        # -- capability dispatch: keep variants whose probe passes now -------
        impls: dict[str, Callable] = {}
        for kind, (fn, avail) in self._impls.items():
            if avail is not None and not avail():
                continue
            impls[kind] = _wrap_body(fn, static, with_result=want_result)
        if not impls:
            raise RuntimeError(
                f"codelet {self.name!r}: no implementation available here "
                f"(registered kinds: {self.impl_kinds})"
            )
        if "cuda" in impls:
            preferred = "cuda"
        elif "ref" in impls:
            preferred = "ref"
        else:
            preferred = next(iter(impls))

        view = graph.insert_task(
            impls,
            accesses,
            arg_layout,
            priority=priority,
            name=name,
            cost=cost,
            comm=self.comm,
        )
        view.task.result_cell = result_cell
        view.task.preferred_kind = preferred
        view.task.policy = policy
        return view

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        spec = ", ".join(f"{s.name}:{s.mode.name.lower()}" for s in self.slots)
        return f"SpCodelet({self.name!r}, [{spec}], impls={self.impl_kinds})"


def _wrap_body(fn: Callable, static: dict, *, with_result: bool = True) -> Callable:
    """Adapt a codelet body to the Task calling convention: the runtime
    appends a hidden result slot (written with the body's return value so
    TaskView.then() chaining has a data-flow edge to hang off).  With
    ``with_result=False`` there is no hidden slot — the body runs on the
    user arguments alone (the fire-and-forget fast path)."""
    if static:
        fn = functools.partial(fn, **static)
    if not with_result:
        return fn  # no hidden slot to pop: the body is the task body

    def body(*task_args):
        *user_args, res_ref = task_args
        out = fn(*user_args)
        res_ref.value = out
        return out

    return body


def sp_task(
    fn: Callable | None = None,
    *,
    read=(),
    write=(),
    commutative=(),
    maybe=(),
    atomic=(),
    name: str | None = None,
    cost: float = 1.0,
    priority: int = 0,
    comm: bool = False,
    result: bool = True,
    retries: int = 0,
    retry_backoff: float = 0.0,
    timeout: float | None = None,
    on_failure: str | None = None,
):
    """Declare a codelet (see module docstring).

    With access-spec keywords, the named positional parameters become data
    slots in signature order; without them, parameters annotated with
    ``SpRead``/``SpWrite``/... become the slots.  All other parameters are
    static and supplied at call time.  ``comm=True`` marks every inserted
    task as a communication task (scheduling hint, see ``SpTaskGraph.task``).

    ``result=False`` declares the codelet fire-and-forget: calls skip the
    hidden result cell, its WRITE access, and the return-value capture,
    shaving per-dispatch overhead for bodies whose effect is entirely
    through their ``write=`` slots.  On such a
    view ``.then()`` / ``.result()`` raise — chain off a written cell
    instead.  Either default can be overridden per call:
    ``codelet(x, y, result=False)``.

    Robustness policy: ``retries``/``retry_backoff`` re-run a
    raising body (exponential backoff between attempts), ``timeout`` arms
    the engine watchdog that fails a hung body with ``SpTaskTimeoutError``,
    and ``on_failure`` picks what a terminal failure does — ``"raise"``
    (park the error for ``wait_all_tasks``), ``"retry"`` (the default once
    ``retries > 0``), or ``"quarantine"`` (keep the graph alive: record the
    task on ``graph.quarantined``, cancel dependents with
    ``CancelledError``, let siblings finish).  Every knob can be overridden
    per call: ``codelet(x, y, retries=3, timeout=0.5)``.

    Speculation: a ``maybe=`` slot makes every inserted task an
    *uncertain writer* — on a graph built with ``SP_MODEL_1``/``SP_MODEL_2``
    a later codelet reading that cell is speculated past it (chains of
    maybe-writers share one snapshot under ``SP_MODEL_2``; see
    ``core/speculation.py``).  A body that leaves the slot untouched
    resolves as "did not write"; assigning ``slot.value`` — even its own
    current value — forces the reader's rollback re-execution.  Because a
    speculated body may run twice, it must be pure in everything except
    idempotent effects; externally visible mutation belongs in a follow-up
    certain-``write`` codelet, which only runs after the outcome is known
    (``repro.serving.spec`` of the JAX package is the worked example:
    draft = maybe-writer, verify = speculated reader, commit = certain
    write).
    """

    def wrap(f: Callable) -> SpCodelet:
        slots, static, has_var_kw = _build_slots(
            f, read, write, commutative, maybe, atomic
        )
        policy = None
        if retries or retry_backoff or timeout is not None or on_failure is not None:
            policy = SpTaskPolicy(
                retries=retries,
                retry_backoff=retry_backoff,
                timeout=timeout,
                on_failure=on_failure,
            )
        return SpCodelet(
            f,
            slots,
            static=static,
            has_var_kw=has_var_kw,
            name=name or f.__name__,
            cost=cost,
            priority=priority,
            comm=comm,
            policy=policy,
            result=result,
        )

    if fn is not None:  # bare @sp_task — annotation spelling
        return wrap(fn)
    return wrap


# ---------------------------------------------------------------------------
# One runtime over both backends.
# ---------------------------------------------------------------------------

class ElasticEvent:
    """What the runtime learned in one recovery, handed to ``on_reshard``.

    ``group`` is the *shrunken* :class:`~repro_torch.core.comm.SpCommGroup` (None
    for local/simulated elasticity), ``dead`` the agreed dead set,
    ``payloads`` each survivor's re-roll payload keyed by physical rank,
    ``resume_step`` the minimum exchanged next step (the hook may return an
    int to override it), ``detect_at``/``reroll_s`` the detection timestamp
    and agreement latency."""

    __slots__ = (
        "epoch", "dead", "payloads", "resume_step", "group",
        "detect_at", "reroll_s",
    )

    def __init__(
        self,
        epoch: int,
        dead: frozenset,
        payloads: dict,
        resume_step: int,
        *,
        group=None,
        detect_at: float | None = None,
        reroll_s: float | None = None,
    ):
        self.epoch = epoch
        self.dead = dead
        self.payloads = payloads
        self.resume_step = resume_step
        self.group = group
        self.detect_at = detect_at
        self.reroll_s = reroll_s

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"ElasticEvent(epoch={self.epoch}, dead={sorted(self.dead)}, "
            f"resume_step={self.resume_step})"
        )


class SpRuntime:
    """Unified entry point (paper Code 1): one constructor, two backends.

    * ``backend="eager"`` — a worker-thread :class:`SpComputeEngine` drives
      the graph; ``workers`` is an int, an ``SpWorkerTeam`` or None
      (default team), ``scheduler`` a name (``make_scheduler``) or instance.
      Pass ``engine=`` to share an existing engine (not stopped on exit).
    * ``backend="staged"`` — tasks accumulate and :meth:`run` (or the first
      ``TaskView.result()``, or scope exit) executes them on the calling
      thread in the ``policy``-linearized order (``core/staged.py``).  Where
      ``repro`` traces that order under ``jax.jit``, the port runs it
      eagerly: each body enqueues its kernels on the card's stream.

    Used as a context manager the runtime opens a graph scope: codelet calls
    inside the block target its graph.  ``SpRuntime(4)`` (a bare int) is the
    legacy spelling for an eager runtime with 4 workers.

    Elastic mode: ``SpRuntime(elastic=True, group=...)`` pushes rank-death
    recovery *into* the runtime — :meth:`run_step` / :meth:`elastic_loop`
    catch ``SpRankDeadError``/``SpCommError`` escaping a step, drive the
    epoch-tagged :func:`~repro_torch.launch.rendezvous.reroll_ranks`
    agreement, rebind ``self.group`` to the shrunken survivors, invoke the
    ``on_reshard`` hook (live resharding: moving the surviving state where
    the new layout wants it) and transparently re-execute from the agreed
    resume step.  User code needs zero failure handling.  With
    ``group=None`` the same loop serves *local* elasticity (simulated chip
    loss): recovery is whatever ``on_reshard`` does.
    """

    def __init__(
        self,
        backend: str | int = "eager",
        *,
        scheduler=None,
        workers=None,
        engine=None,
        policy: str = "fifo",
        speculative_model: SpSpeculativeModel = SpSpeculativeModel.SP_NO_SPEC,
        trace: bool = True,
        n_threads: int | None = None,
        elastic: bool = False,
        group=None,
        on_reshard: Callable[["ElasticEvent"], Optional[int]] | None = None,
        reroll_timeout: float = 30.0,
        detect_grace: float = 10.0,
    ):
        if isinstance(backend, int):  # legacy SpRuntime(n_threads)
            n_threads = backend
            backend = "eager"
        if backend not in ("eager", "staged"):
            raise ValueError(f"unknown backend {backend!r}; use 'eager' or 'staged'")
        if elastic and backend != "eager":
            raise ValueError(
                "elastic=True needs the eager backend: recovery re-executes "
                "steps on live worker threads"
            )
        self.backend = backend
        self.policy = policy
        self.graph = SpTaskGraph(speculative_model, trace=trace)
        self.engine = None
        self._own_engine = False
        self._scope_token = None
        self._order = None  # last staged schedule (list of Tasks)
        self.elastic = bool(elastic)
        self.group = group
        self.on_reshard = on_reshard
        self.reroll_timeout = reroll_timeout
        self.detect_grace = detect_grace
        self.epoch = 0
        self.recoveries: list[dict] = []  # one record per survived failure

        if backend == "eager":
            from .engine import SpComputeEngine, SpWorkerTeam, SpWorkerTeamBuilder
            from .scheduler import make_scheduler

            if engine is not None:
                self.engine = engine
            else:
                if isinstance(scheduler, str):
                    scheduler = make_scheduler(scheduler)
                team = workers
                if team is None:
                    team = SpWorkerTeamBuilder.team_of_cpu_workers(n_threads)
                elif isinstance(team, int):
                    team = SpWorkerTeamBuilder.team_of_cpu_workers(team)
                elif not isinstance(team, SpWorkerTeam):
                    raise TypeError(
                        f"workers must be an int or SpWorkerTeam, got {team!r}"
                    )
                self.engine = SpComputeEngine(team, scheduler)
                self._own_engine = True
            self.graph.compute_on(self.engine)
        else:
            if engine is not None or workers is not None or scheduler is not None:
                raise ValueError(
                    "backend='staged' runs the schedule on the calling thread — "
                    "it takes policy=..., not workers/scheduler/engine"
                )
            # TaskView.result() on an unflushed staged graph triggers this
            self.graph._flush_hook = self.run

    def task(self, *args, **kw) -> TaskView:
        """Positional-spelling shim (``SpTaskGraph.task`` passthrough)."""
        return self.graph.task(*args, **kw)

    def run(self) -> list:
        """Execute pending work; returns the staged schedule (eager: [])."""
        if self.backend == "eager":
            self.graph.wait_all_tasks()
            return []
        return self._flush()

    def _flush(self) -> list:
        from .staged import linearize, run_schedule

        graph = self.graph
        if not graph.tasks:
            return []
        if graph.unfinished == 0:
            return self._order or []
        order = linearize(graph, self.policy)
        self._order = order
        # the codelet frontend stamps the preferred kind at bind time
        # (pick_impl falls back to 'ref' when it is absent).  Errors are
        # parked on the tasks/graph — surfaced by result() or
        # wait_all_tasks, not here.
        run_schedule(
            graph, order, lambda t: getattr(t, "preferred_kind", None) or "ref"
        )
        return order

    @property
    def schedule(self) -> list:
        """The staged task order of the last :meth:`run` (staged backend)."""
        return list(self._order or [])

    def wait_all_tasks(self, timeout: float | None = None, raise_errors: bool = True) -> None:
        if self.backend == "staged":
            self._flush()
        self.graph.wait_all_tasks(timeout, raise_errors=raise_errors)

    waitAllTasks = wait_all_tasks

    # -------------------------------------------------------------- elasticity

    def _begin_step(self) -> SpTaskGraph:
        """Open a fresh per-step graph on the shared engine and make it the
        insertion scope.  A step that fails mid-collective is abandoned
        wholesale — its lingering receives time out harmlessly on the comm
        thread while the next step inserts into a clean graph."""
        self.graph = SpTaskGraph(trace=False).compute_on(self.engine)
        if self._scope_token is not None:
            _scope.reset(self._scope_token)
            self._scope_token = _scope.set(self.graph)
        return self.graph

    def _await_step(self, tg: SpTaskGraph, timeout: float) -> bool:
        """Wait for the step graph; ``False`` when a group member died
        while we waited (the transport's dead set grew), re-raising
        anything unrelated to rank death."""
        from .comm import SpCommError

        transport = self.group.hub if self.group is not None else None
        deadline = time.monotonic() + timeout
        while True:
            try:
                tg.wait_all_tasks(timeout=0.1)
                return True
            except TimeoutError:
                if transport is not None and (
                    transport.dead_ranks & set(self.group.members)
                ):
                    return False
                if time.monotonic() > deadline:
                    raise
            except SpCommError:
                return False

    def _recover(self, step: int) -> int:
        """One recovery: agree on the dead set, shrink the group, call the
        reshard hook, return the step to resume from."""
        from .comm import SpCommError

        t_fail = time.monotonic()
        if self.group is None:
            # local/simulated elasticity (launch/train.py): nothing to
            # re-roll — recovery is whatever the reshard hook does
            self.epoch += 1
            resume = step
            event = ElasticEvent(self.epoch, frozenset(), {}, step)
            if self.on_reshard is not None:
                override = self.on_reshard(event)
                if override is not None:
                    resume = int(override)
            self.recoveries.append(
                {
                    "epoch": self.epoch,
                    "mode": "local",
                    "step": step,
                    "resume": resume,
                    "seconds": time.monotonic() - t_fail,
                }
            )
            return resume

        from ..launch.rendezvous import reroll_ranks

        transport = self.group.hub
        members = set(self.group.members)
        # the task error can beat the router's death broadcast by a tick —
        # give the failure detector a moment to learn who died
        learn_by = time.monotonic() + self.detect_grace
        while not (transport.dead_ranks & members):
            if time.monotonic() > learn_by:
                raise SpCommError(
                    f"rank {self.group.rank}: step {step} failed but no rank "
                    f"was declared dead within {self.detect_grace}s"
                )
            time.sleep(0.005)
        dead_now = transport.dead_ranks & members
        detect_at = min(
            transport.death_detected_at(r) or time.monotonic() for r in dead_now
        )
        last_exc: Optional[BaseException] = None
        for _ in range(5):
            # a death landing between re-roll rounds diverges the dead set;
            # the protocol says: re-roll with a fresh epoch
            self.epoch += 1
            t0 = time.monotonic()
            try:
                group, dead, payloads = reroll_ranks(
                    self.group,
                    epoch=self.epoch,
                    payload={"next_step": step},
                    timeout=self.reroll_timeout,
                )
                break
            except SpCommError as e:
                last_exc = e
                time.sleep(0.01)
        else:
            raise last_exc  # type: ignore[misc]
        reroll_s = time.monotonic() - t0
        self.group = group
        resume = min(p["next_step"] for p in payloads.values())
        event = ElasticEvent(
            self.epoch,
            dead,
            payloads,
            resume,
            group=group,
            detect_at=detect_at,
            reroll_s=reroll_s,
        )
        if self.on_reshard is not None:
            override = self.on_reshard(event)
            if override is not None:
                resume = int(override)
        self.recoveries.append(
            {
                "epoch": self.epoch,
                "mode": "reroll",
                "step": step,
                "resume": resume,
                "dead": sorted(dead),
                "members": list(group.members),
                "detect_at": detect_at,
                "reroll_s": reroll_s,
                "seconds": time.monotonic() - t_fail,
            }
        )
        return resume

    def barrier(self, timeout: float = 60.0) -> None:
        """Wait for the current step graph to drain.  Raises
        ``SpRankDeadError`` when a group member died while waiting — inside
        :meth:`run_step` / :meth:`elastic_loop` that triggers transparent
        recovery, so a step function can synchronize mid-step (e.g. to read
        a collective's result) without any failure handling of its own."""
        if not self._await_step(self.graph, timeout):
            from .comm import SpRankDeadError

            raise SpRankDeadError(
                f"a member of {sorted(self.group.members)} died during the step"
            )

    def run_step(self, fn: Callable[[int], Any], *, step: int = 0,
                 step_timeout: float = 60.0) -> Any:
        """Execute ``fn(step)`` inside a fresh per-step graph, surviving
        rank death: on failure the runtime re-rolls the group, reshards and
        re-executes the *same* step.  ``fn`` must be re-runnable from its
        inputs (use :meth:`elastic_loop` when survivors may need to rewind
        to an earlier step)."""
        if not self.elastic:
            raise RuntimeError("run_step requires SpRuntime(elastic=True)")
        from .comm import SpCommError, SpRankDeadError

        while True:
            tg = self._begin_step()
            try:
                out = fn(step)
                failed = not self._await_step(tg, step_timeout)
            except (SpRankDeadError, SpCommError):
                failed = True
            if not failed:
                return out
            self._recover(step)

    def elastic_loop(self, fn: Callable[[int], Any], steps: int, *,
                     start: int = 0, step_timeout: float = 60.0) -> dict[int, Any]:
        """Drive ``fn(step)`` for ``step in range(start, steps)`` with
        in-runtime failure recovery: each step gets a fresh graph; a rank
        death re-rolls the group, reshards (``on_reshard``) and resumes
        from the minimum step any survivor still needs — re-executing
        completed steps when a peer was behind, so ``fn`` must be
        deterministic given its step index.  Returns ``{step: result}``
        with the *last* execution of each step."""
        if not self.elastic:
            raise RuntimeError("elastic_loop requires SpRuntime(elastic=True)")
        from .comm import SpCommError, SpRankDeadError

        results: dict[int, Any] = {}
        step = start
        while step < steps:
            tg = self._begin_step()
            try:
                out = fn(step)
                failed = not self._await_step(tg, step_timeout)
            except (SpRankDeadError, SpCommError):
                failed = True
            if failed:
                step = self._recover(step)
                continue
            results[step] = out
            step += 1
        return results

    def stop(self) -> None:
        if self._own_engine and self.engine is not None:
            self.engine.stop()

    def __enter__(self) -> "SpRuntime":
        self._scope_token = _scope.set(self.graph)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._scope_token is not None:
            _scope.reset(self._scope_token)
            self._scope_token = None
        try:
            if exc_type is None:
                self.wait_all_tasks()
        finally:
            self.stop()
