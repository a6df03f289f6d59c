"""Fault tolerance: duplicated tasks, failure injection, the re-mesh plan
— the port's copy of ``repro.dist.fault``.

All of it rides on machinery the core runtime already has:

* :class:`CancelToken` + :func:`run_duplicated` — straggler/fault mitigation
  by replication.  ``n`` copies of a task race; the first to finish claims
  the token, and the engine's cancellation hook (``SpComputeEngine._execute``
  checks ``task.cancel_token`` before running) turns every not-yet-started
  copy into a no-op.  First-result-wins; the select is deterministic because
  all copies compute the same pure function.

* :class:`FailureSimulator` — scripted rank loss for tests and the launcher:
  a ``{step: ranks_lost}`` plan checked once per training step.

* :func:`remesh_plan` — given the surviving chip count, compute the largest
  mesh that preserves model parallelism (a ``model`` axis of fixed size) by
  shrinking the pure-data axes, idling any remainder chips.

Fault tolerance & recovery
--------------------------

* **Detection** lives in ``repro_torch.core.comm``: on the p2p data plane
  every rank heartbeats its *direct* peer links (plus the rank-0 control
  link), so EOF-without-goodbye and stale heartbeats are
  **peer-observed** — whichever rank sees the death first gossips a
  ``dead`` notice over all its links and every survivor's pending *and*
  future requests addressed to that rank fail with a typed
  :class:`~repro_torch.core.SpRankDeadError` in O(heartbeat) — dependent
  tasks cancel transitively, exactly as timeouts do.  No router sits in
  the detection path: killing rank 0 itself is detected the same way.

* **Injection** — :class:`FaultyTransport` wraps any ``SpTransport`` and
  drops, delays, duplicates, or truncates messages and kills ranks on a
  deterministic seeded schedule.  Injected send-side faults raise
  :class:`~repro_torch.core.SpCommTransientError` (a *retryable* link
  fault, distinct from rank death); duplicates are filtered by a
  receive-side ``(src, seq)`` dedup window, which is also what makes send
  retry idempotent.  With ``peers=``, injection is scoped to the
  *per-peer streams* named — posts to other destinations pass through
  untouched.

* **Retry** — :class:`RetryingTransport` wraps a (possibly faulty)
  transport with a bounded exponential-backoff retry budget for transient
  faults; on exhaustion it escalates, marking the peer dead and raising
  ``SpRankDeadError`` — transient faults are absorbed, real deaths are
  not masked.

* **Recovery** — on ``SpRankDeadError`` survivors agree on the dead set
  via an epoch-tagged rendezvous re-roll
  (``repro_torch.launch.rendezvous.reroll_ranks``), shrink the
  communicator (``SpCommGroup.shrunk``; ring collectives run on *logical*
  coordinates so the shrunken ring stays closed) and re-execute from the
  agreed step.  ``SpRuntime(elastic=True)`` owns that choreography:

  - *what the runtime promises:* inside
    :meth:`~repro_torch.core.SpRuntime.run_step` / ``elastic_loop`` every
    step runs in a fresh graph; when a group member dies the runtime
    re-rolls the group with a fresh epoch, rebinds ``rt.group``, invokes
    the ``on_reshard`` hook (domain work only) and re-executes from the
    **minimum** step any survivor still needs, recording each recovery in
    ``rt.recoveries``;
  - *what the step function promises:* it is deterministic and
    re-runnable given its step index, tags collectives with
    ``(rt.epoch, step)``, and contains **no failure handling**.

  The port trains on one card, so its launcher's re-mesh is the
  one-device case (``launch/train.py``); the re-mesh over several cards
  and the chaos soak (``dist/chaos.py``) wait (ROADMAP.md, Queue 1 item 5).
"""
from __future__ import annotations

import collections
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

from repro_torch.core.access import SpData
from repro_torch.core.api import sp_task
from repro_torch.core.comm import SpCommTransientError, SpRankDeadError, SpTransport
from repro_torch.core.graph import SpTaskGraph
from repro_torch.core.task import TaskView


class CancelToken:
    """First-result-wins latch shared by a set of duplicated tasks.

    ``set(task)`` claims the token (only the first claim sticks and records
    ``winner``); ``is_set()`` is the engine's pre-execution cancellation
    check.  A copy that *raised* must not claim the token — the engine
    records it via :meth:`record_failure` instead, so healthy replicas keep
    racing and the failure is only surfaced if every copy loses.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._claimed = False
        self.winner = None
        self.failures: list[BaseException] = []

    def set(self, task=None) -> bool:
        """Claim the token for ``task``; True iff this call won."""
        with self._lock:
            if self._claimed:
                return False
            self._claimed = True
            self.winner = task
            self._event.set()
            return True

    def record_failure(self, exc: BaseException) -> None:
        with self._lock:
            self.failures.append(exc)

    def is_set(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


@sp_task(read=("inputs",), commutative=("out",), name="dup.copy")
def _dup_copy(inputs, out, *, fn):
    out.value = fn(*inputs)
    return out.value


@sp_task(read=("winner",), name="dup.select")
def _dup_select(winner, *, token, n, label):
    if token.winner is None:
        raise RuntimeError(
            f"{label}: all {n} duplicated copies failed"
        ) from (token.failures[0] if token.failures else None)
    return winner


def run_duplicated(
    graph: SpTaskGraph,
    fn: Callable,
    inputs: Sequence[SpData],
    out: SpData,
    *,
    n: int = 2,
    name: str = "dup",
    cost: float = 1.0,
) -> TaskView:
    """Insert ``n`` replicated copies of ``fn(*inputs) -> out`` plus a
    select task; returns the select's view (its value is the winner's
    result).

    Copies write ``out`` commutatively (order-free, mutually exclusive), so
    the scheduler may run them concurrently on different workers; whichever
    finishes first claims the shared :class:`CancelToken` and the engine
    cancels the stragglers before they start.  ``fn`` must be pure — a
    copy that already started when the winner finished simply recomputes
    the same value.
    """
    if n < 1:
        raise ValueError("need at least one copy")
    token = CancelToken()

    for i in range(n):
        view = _dup_copy(
            list(inputs), out, fn=fn,
            graph=graph, name=f"{name}.copy{i}", cost=cost,
        )
        view.task.cancel_token = token

    return _dup_select(out, token=token, n=n, label=name,
                       graph=graph, name=f"{name}.select")


class FailureSimulator:
    """Scripted rank loss: ``plan`` maps step → number of ranks lost when
    that step is reached.  Training loops call :meth:`check` once per step.

    ``flaky`` scripts *transient* outages — ``{step: down_for}`` means the
    flaky ranks go dark at ``step`` and recover ``down_for`` steps later;
    loops call :meth:`flaky_down` once per step and should treat a True
    return as "retry this step's communication", not as a death."""

    def __init__(
        self,
        plan: dict[int, int],
        *,
        flaky: Optional[dict[int, int]] = None,
    ):
        self.plan = dict(plan)
        self.events: list[tuple[int, int]] = []
        self.flaky = dict(flaky or {})
        self.flaky_events: list[tuple[int, int]] = []
        self._down_until: Optional[int] = None

    def check(self, step: int) -> int:
        """Ranks lost at ``step`` (0 if none); records the event.  Each
        planned failure fires exactly once — the rank stays dead, so
        replaying the step after a restore must not kill it again."""
        lost = int(self.plan.pop(step, 0))
        if lost:
            self.events.append((step, lost))
        return lost

    def flaky_down(self, step: int) -> bool:
        """True while a scripted transient outage covers ``step``.  An
        outage starting at step ``s`` with duration ``d`` covers steps
        ``s .. s+d-1``; at ``s+d`` the ranks have recovered.  Like
        :meth:`check`, each outage fires exactly once."""
        if step in self.flaky:
            until = step + int(self.flaky.pop(step))
            self.flaky_events.append((step, until))
            self._down_until = until
        if self._down_until is not None and step < self._down_until:
            return True
        self._down_until = None
        return False

    @property
    def total_lost(self) -> int:
        return sum(n for _, n in self.events)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"FailureSimulator({self.plan}, lost={self.total_lost})"


# ---------------------------------------------------------------------------
# Fault injection + retry: the harness the detection/retry layer is
# verified with (module docstring, "Fault tolerance & recovery").
# ---------------------------------------------------------------------------

_WRAP = "__fault__"       # wrapped payload marker: (_WRAP, src, seq, msg)
_CORRUPT = "__corrupt__"  # truncated-frame marker: (_CORRUPT, src, seq)


class FaultyTransport(SpTransport):
    """Deterministic fault injector over any :class:`SpTransport`.

    Every ``post`` consumes draws from a seeded PRNG in a fixed order
    (drop, duplicate, delay, truncate), so a given ``seed`` plus a given
    call sequence always injects the same fault schedule — tests replay
    schedules exactly.

    Fault model (probabilities in [0, 1]):

    * ``drop`` — the message is lost in flight; the sender *sees* the loss
      as :class:`SpCommTransientError` (a failed send syscall), so a retry
      wrapper can re-post it.
    * ``duplicate`` — the message is deposited twice; the receive side
      dedups via a ``(src, seq)`` window so pollers still see it once.
      The same window makes send-side *retries* idempotent.
    * ``delay`` — delivery is deferred ``delay_s`` seconds (a timer thread
      deposits late); the post itself succeeds.
    * ``truncate`` — a corrupt marker reaches the receiver (discarded and
      counted on poll) and the sender gets ``SpCommTransientError``.

    Scripted, non-random faults:

    * ``kill_plan`` — ``{post_ordinal: rank}``: when the Nth post through
      this wrapper starts, ``rank`` is marked dead on the inner transport
      (subsequent posts to it raise ``SpRankDeadError``).
    * ``flaky`` — ``{rank: n_failures}``: the next ``n`` posts to ``rank``
      raise ``SpCommTransientError``, then the rank recovers — the
      flaky-then-recovering peer a retry budget must absorb.

    ``peers`` (optional) restricts injection to posts whose *destination*
    is in the set — the per-peer-stream scoping the p2p data plane needs:
    posts to any other rank bypass the PRNG entirely (no draws consumed,
    no wrap), so the fault schedule on the named streams is independent
    of traffic elsewhere.  ``kill_plan`` ordinals likewise count only
    posts on the named streams.

    ``injected`` counts every fault by kind.  All wrapped payloads are
    ``(_WRAP, src, seq, msg)`` tuples; :meth:`poll` unwraps, so wrap and
    unwrap must happen on the same layer — wrap *both* ends of a link (or
    share one wrapper, e.g. around a ``ChannelHub``)."""

    def __init__(
        self,
        inner: SpTransport,
        *,
        seed: int = 0,
        drop: float = 0.0,
        duplicate: float = 0.0,
        delay: float = 0.0,
        delay_s: float = 0.005,
        truncate: float = 0.0,
        kill_plan: Optional[dict[int, int]] = None,
        flaky: Optional[dict[int, int]] = None,
        dedup_window: int = 4096,
        peers: Optional[Sequence[int]] = None,
    ):
        self.inner = inner
        self._peers = None if peers is None else frozenset(peers)
        self._rng = random.Random(seed)
        self._p = {"drop": drop, "duplicate": duplicate,
                   "delay": delay, "truncate": truncate}
        self._delay_s = delay_s
        self._kill_plan = dict(kill_plan or {})
        self._flaky = dict(flaky or {})
        self._dedup_window = dedup_window
        self._lock = threading.Lock()
        self._seq = 0
        self._post_ordinal = 0
        self._seen: collections.deque = collections.deque()
        self._seen_set: set = set()
        self._timers: list[threading.Timer] = []
        self.injected = {
            "dropped": 0, "duplicated": 0, "delayed": 0, "truncated": 0,
            "flaky": 0, "killed": 0, "deduped": 0, "corrupt_discarded": 0,
        }

    # -- send side -----------------------------------------------------------

    def _draw(self, kind: str) -> bool:
        # one draw per fault kind per post, in fixed order — determinism
        # does not depend on which faults are enabled
        return self._rng.random() < self._p[kind]

    def post(self, key: tuple, msg: Any) -> None:
        src, dst, _tag = key
        if self._peers is not None and dst not in self._peers:
            self.inner.post(key, msg)  # off-stream: untouched, no draws
            return
        with self._lock:
            ordinal = self._post_ordinal
            self._post_ordinal += 1
            seq = self._seq
            self._seq += 1
            victim = self._kill_plan.pop(ordinal, None)
            flaky_left = self._flaky.get(dst, 0)
            if flaky_left > 0:
                self._flaky[dst] = flaky_left - 1
            # draws happen under the lock so concurrent posters still see
            # one deterministic global schedule
            drop = self._draw("drop")
            dup = self._draw("duplicate")
            delay = self._draw("delay")
            trunc = self._draw("truncate")
        if victim is not None:
            self.injected["killed"] += 1
            self.mark_dead(victim)
        if flaky_left > 0:
            self.injected["flaky"] += 1
            raise SpCommTransientError(
                f"rank {dst} is flaky: injected send failure "
                f"({flaky_left - 1} more before recovery)"
            )
        wrapped = (_WRAP, src, seq, msg)
        if drop:
            self.injected["dropped"] += 1
            raise SpCommTransientError(
                f"injected drop of post {key!r} (seq {seq})"
            )
        if trunc:
            self.injected["truncated"] += 1
            self.inner.post(key, (_CORRUPT, src, seq))
            raise SpCommTransientError(
                f"injected truncation of post {key!r} (seq {seq})"
            )
        if delay:
            self.injected["delayed"] += 1
            t = threading.Timer(
                self._delay_s, self.inner.post, args=(key, wrapped)
            )
            t.daemon = True
            with self._lock:
                self._timers.append(t)
            t.start()
        else:
            self.inner.post(key, wrapped)
        if dup:
            self.injected["duplicated"] += 1
            self.inner.post(key, wrapped)

    # -- receive side --------------------------------------------------------

    def poll(self, key: tuple) -> tuple[bool, Any]:
        while True:
            ok, msg = self.inner.poll(key)
            if not ok:
                return False, None
            if isinstance(msg, tuple) and msg and msg[0] == _CORRUPT:
                self.injected["corrupt_discarded"] += 1
                continue
            if isinstance(msg, tuple) and msg and msg[0] == _WRAP:
                _, src, seq, payload = msg
                with self._lock:
                    if (src, seq) in self._seen_set:
                        self.injected["deduped"] += 1
                        continue
                    self._seen_set.add((src, seq))
                    self._seen.append((src, seq))
                    while len(self._seen) > self._dedup_window:
                        self._seen_set.discard(self._seen.popleft())
                return True, payload
            return True, msg  # unwrapped message from a non-faulty sender

    # -- delegation ----------------------------------------------------------

    @property
    def dead_ranks(self) -> frozenset:
        return self.inner.dead_ranks

    def mark_dead(self, rank: int) -> None:
        self.inner.mark_dead(rank)

    def death_detected_at(self, rank: int) -> Optional[float]:
        return self.inner.death_detected_at(rank)

    def recover(self, rank: int) -> None:
        """Clear any remaining scripted flakiness for ``rank`` (the peer
        'reconnected')."""
        with self._lock:
            self._flaky.pop(rank, None)

    def stats(self) -> dict:
        st = dict(self.inner.stats())
        st["faults"] = dict(self.injected)
        return st

    def reset(self) -> None:
        self.inner.reset()
        with self._lock:
            self._seen.clear()
            self._seen_set.clear()

    def close(self) -> None:
        with self._lock:
            timers = list(self._timers)
            self._timers.clear()
        for t in timers:
            t.cancel()
        self.inner.close()


class RetryingTransport(SpTransport):
    """Bounded retry-with-backoff over a (possibly fault-injecting)
    transport.

    ``post`` retries on :class:`SpCommTransientError` up to ``max_retries``
    times with exponential backoff (``backoff * factor**attempt``, capped
    at ``max_backoff``).  Retried posts are idempotent because
    :class:`FaultyTransport`'s receive side dedups on ``(src, seq)`` — a
    'drop' that actually delivered cannot double-deliver.  When the budget
    is exhausted, the wrapper *escalates*: the destination is marked dead
    on the inner transport and :class:`SpRankDeadError` is raised — a link
    that stays down is a dead peer, not an infinitely-retryable blip.

    ``poll`` passes through untouched (including ``SpRankDeadError``): the
    poll path must stay non-blocking, so there is nothing to retry."""

    def __init__(
        self,
        inner: SpTransport,
        *,
        max_retries: int = 5,
        backoff: float = 0.002,
        factor: float = 2.0,
        max_backoff: float = 0.25,
    ):
        self.inner = inner
        self.max_retries = max_retries
        self.backoff = backoff
        self.factor = factor
        self.max_backoff = max_backoff
        self.retries = 0
        self.escalations = 0

    def post(self, key: tuple, msg: Any) -> None:
        last: Optional[SpCommTransientError] = None
        for attempt in range(self.max_retries + 1):
            try:
                self.inner.post(key, msg)
                return
            except SpCommTransientError as e:
                last = e
                if attempt < self.max_retries:
                    self.retries += 1
                    time.sleep(
                        min(self.backoff * self.factor ** attempt,
                            self.max_backoff)
                    )
        dst = key[1]
        self.escalations += 1
        self.inner.mark_dead(dst)
        raise SpRankDeadError(
            f"rank {dst}: send failed {self.max_retries + 1} times "
            f"({last}); escalating transient faults to rank-dead"
        ) from last

    def poll(self, key: tuple) -> tuple[bool, Any]:
        return self.inner.poll(key)

    @property
    def dead_ranks(self) -> frozenset:
        return self.inner.dead_ranks

    def mark_dead(self, rank: int) -> None:
        self.inner.mark_dead(rank)

    def death_detected_at(self, rank: int) -> Optional[float]:
        return self.inner.death_detected_at(rank)

    def stats(self) -> dict:
        st = dict(self.inner.stats())
        st["retries"] = self.retries
        st["escalations"] = self.escalations
        return st

    def reset(self) -> None:
        self.inner.reset()

    def close(self) -> None:
        self.inner.close()


@dataclass(frozen=True)
class RemeshPlan:
    """A shrunken mesh layout: the first ``n_chips`` devices, laid out as
    ``shape`` over the named ``axes``."""

    shape: tuple[int, ...]
    axes: tuple[str, ...]
    n_chips: int
    dropped_chips: int  # failed + idled (alive but unused) chips
    model_parallel: int


def remesh_plan(
    n_total: int,
    n_failed: int,
    *,
    model_parallel: int,
    pod_size: Optional[int] = None,
) -> RemeshPlan:
    """Largest mesh on the survivors of ``n_total`` chips that preserves a
    ``model`` axis of exactly ``model_parallel``.

    The ``model`` axis must survive intact (param shards per layer stay
    addressable); only pure-data axes shrink.  With ``pod_size``, whole
    surviving pods keep the 3-axis ``(pod, data, model)`` layout; once fewer
    than two full pods survive, the plan collapses to single-pod
    ``(data, model)`` over all remaining chips.  Raises ``RuntimeError``
    when fewer than ``model_parallel`` chips survive — at that point the
    job cannot continue and must be rescheduled, not re-meshed.
    """
    if model_parallel < 1:
        raise ValueError("model_parallel must be >= 1")
    alive = n_total - n_failed
    if alive < model_parallel:
        raise RuntimeError(
            f"{alive} chips survive of {n_total}; cannot preserve "
            f"model_parallel={model_parallel} — reschedule instead of re-mesh"
        )
    if pod_size is not None and pod_size % model_parallel:
        raise ValueError("pod_size must be a multiple of model_parallel")
    if pod_size is not None:
        pods = alive // pod_size
        if pods >= 2:
            data = pod_size // model_parallel
            n_chips = pods * pod_size
            return RemeshPlan(
                (pods, data, model_parallel),
                ("pod", "data", "model"),
                n_chips,
                n_total - n_chips,
                model_parallel,
            )
    data = alive // model_parallel
    n_chips = data * model_parallel
    return RemeshPlan(
        (data, model_parallel),
        ("data", "model"),
        n_chips,
        n_total - n_chips,
        model_parallel,
    )
