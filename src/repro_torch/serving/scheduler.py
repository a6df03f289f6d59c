"""Admission control and continuous-batch scheduling for the serve engine.

DuctTeip's lesson (PAPERS.md) applies directly here: at serving scale the
bottleneck is the data/admission plane, not the task graph.  This module is
that plane:

* :class:`AdmissionQueue` semantics live inside :class:`ServeScheduler` — a
  **bounded** wait queue with an overload policy: ``"reject"`` raises
  :class:`AdmissionError` at submit time (backpressure to the caller),
  ``"shed-oldest"`` drops the longest-waiting request (marked
  ``req.rejected``) to make room for the newcomer.  Every rejected request
  carries ``req.reject_reason`` — ``"queue_full"`` (reject policy),
  ``"shed"`` (overflow victim), or ``"deadline"`` (expired before it could
  be served) — so callers can distinguish overload from latency misses.

* Deadlines: a request submitted with ``deadline=`` (absolute
  ``time.perf_counter()`` seconds) is shed instead of admitted once the
  deadline passes — serving a request nobody is still waiting for wastes
  slots and KV blocks that on-time requests need.  The overflow shed is
  deadline-aware too: an already-expired waiter is preferred as the victim
  over the oldest viable one.  Mid-decode expiry and user ``cancel()`` are
  handled engine-side in the collect codelet (the only place slot state
  may be mutated), which releases the sequence's KV blocks immediately.

* :meth:`ServeScheduler.plan` decides, between engine iterations, which
  waiting requests join the decode batch.  A request is admitted only when
  a batch slot is free **and** the paged pool can hold its prompt blocks —
  a failed block allocation leaves the request queued (backpressure under
  memory pressure) rather than crashing the serve loop.  For each admission
  it picks one of three data paths:

  - ``"restore"`` — every needed block is live and payload-backed
    (prefix-cache hit, or a preempted sequence resuming): the engine
    scatters saved KV rows back into the slot and skips prefill entirely.
  - ``"prefill"`` — fresh request: run prefill, sample the first token
    from its logits.
  - ``"prefill-resume"`` — a preempted sequence whose blocks were evicted:
    re-prefill prompt + generated-so-far to rebuild the KV rows (the next
    token is already known, so prefill logits are discarded).

* Preemption: when a mid-decode block append cannot be satisfied, the
  engine asks :meth:`preemption_victim` — youngest-admitted-first, the
  request that has sunk the least work.

The scheduler exposes ``queue_depth`` and per-counter stats so overload is
observable (``ServeEngine.stats()`` merges them with pool occupancy).
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Optional

from repro_torch.serving.kvcache import KVPagePool, PageError


class AdmissionError(RuntimeError):
    """Submit rejected: the bounded admission queue is full."""


@dataclass
class Admission:
    """One planned admission: the request, its batch slot, and the data path
    (``"restore"`` / ``"prefill"`` / ``"prefill-resume"``)."""

    req: object
    slot: int
    mode: str


class ServeScheduler:
    """Bounded admission queue + slot/block-aware admission planning."""

    def __init__(
        self,
        pool: KVPagePool,
        n_slots: int,
        *,
        max_queue: int = 64,
        overload: str = "reject",
        max_batch: Optional[int] = None,
        admit_max_wait: float = 0.0,
        draft_k: int = 0,
    ):
        if overload not in ("reject", "shed-oldest"):
            raise ValueError(f"unknown overload policy {overload!r}")
        if max_batch is not None and not (1 <= max_batch <= n_slots):
            raise ValueError(f"max_batch must be in [1, {n_slots}]")
        self.pool = pool
        self.n_slots = n_slots
        self.max_queue = max_queue
        self.overload = overload
        #: cap on concurrently decoding sequences (None = all slots); lets a
        #: deployment trade per-request latency against batch efficiency
        self.max_batch = max_batch
        #: hold admissions up to this many seconds so near-simultaneous
        #: arrivals join the batch together (NeMo-style batching timeout);
        #: 0.0 admits greedily
        self.admit_max_wait = float(admit_max_wait)
        #: speculative-decoding draft depth policy knob (0 = disabled);
        #: :meth:`draft_depth` sheds speculation under pool pressure
        self.draft_k = int(draft_k)
        self._waiting: collections.deque = collections.deque()
        self._free_slots: list[int] = list(range(n_slots))
        self._lock = threading.Lock()
        self._admit_seq = itertools.count()
        self.rejected = 0
        self.shed = 0
        self.admitted = 0
        self.preemptions = 0
        self.deadline_shed = 0
        self.cancelled = 0

    # ------------------------------------------------------------- queueing

    def submit(self, req) -> None:
        """Enqueue; on overflow apply the overload policy.  The shed is
        deadline-aware: an already-expired waiter is evicted in preference
        to the oldest still-viable one."""
        with self._lock:
            if len(self._waiting) >= self.max_queue:
                if self.overload == "reject":
                    self.rejected += 1
                    req.rejected = True
                    req.reject_reason = "queue_full"
                    req.done = True
                    raise AdmissionError(
                        f"admission queue full ({self.max_queue} waiting); "
                        "request rejected"
                    )
                idx, reason = self._pick_shed_victim()
                victim = self._waiting[idx]
                del self._waiting[idx]  # by index: Request.__eq__ is not usable
                self._drop(victim, reason)
            self._waiting.append(req)

    def _pick_shed_victim(self):
        """(index, reason) under shed-oldest overflow: the first expired
        waiter if any, else the longest-waiting one.  Caller holds _lock."""
        now = time.perf_counter()
        for i, cand in enumerate(self._waiting):
            dl = getattr(cand, "deadline", None)
            if dl is not None and now > dl:
                return i, "deadline"
        return 0, "shed"

    def _drop(self, req, reason: str) -> None:
        """Mark a waiting request rejected and count it.  Caller holds _lock."""
        req.rejected = True
        req.reject_reason = reason
        req.done = True
        if reason == "deadline":
            self.deadline_shed += 1
        else:
            self.shed += 1

    def requeue(self, req) -> None:
        """Put a preempted request back at the head of the queue."""
        with self._lock:
            self._waiting.appendleft(req)
        self.preemptions += 1

    @property
    def queue_depth(self) -> int:
        return len(self._waiting)

    @property
    def slot_occupancy(self) -> float:
        with self._lock:
            return (self.n_slots - len(self._free_slots)) / self.n_slots

    def free_slot(self, slot: int) -> None:
        with self._lock:
            self._free_slots.append(slot)
            self._free_slots.sort()

    # ------------------------------------------------------------- planning

    def plan(self, *, pageable: bool) -> list[Admission]:
        """Admit waiting requests while slots and blocks allow.  Block
        allocation happens here (driver thread, graph drained) so the
        admission either fully reserves its memory or stays queued.
        Cancelled and deadline-expired waiters are dropped first — admitting
        them would spend prefill compute and KV blocks on dead work."""
        out: list[Admission] = []
        now = time.perf_counter()
        with self._lock:
            keep: collections.deque = collections.deque()
            for req in self._waiting:
                if getattr(req, "cancelled", False):
                    req.done = True
                    self.cancelled += 1
                elif getattr(req, "deadline", None) is not None and now > req.deadline:
                    self._drop(req, "deadline")
                else:
                    keep.append(req)
            self._waiting = keep
            while self._waiting and self._free_slots:
                running = self.n_slots - len(self._free_slots)
                if self.max_batch is not None and running >= self.max_batch:
                    break
                if self.admit_max_wait > 0.0:
                    # batching window: hold off while the batch could still
                    # fill AND nobody has waited past the window
                    capacity = len(self._free_slots)
                    if self.max_batch is not None:
                        capacity = min(capacity, self.max_batch - running)
                    oldest = self._waiting[0]
                    waited = now - (getattr(oldest, "t_arrival", None) or now)
                    if waited < self.admit_max_wait and len(self._waiting) < capacity:
                        break
                req = self._waiting[0]
                try:
                    mode = self._reserve(req, pageable)
                except PageError:
                    break  # backpressure: pool full, keep the request queued
                self._waiting.popleft()
                slot = self._free_slots.pop(0)
                req.admit_order = next(self._admit_seq)
                self.admitted += 1
                out.append(Admission(req, slot, mode))
        return out

    def _reserve(self, req, pageable: bool) -> str:
        """Pin blocks for ``req`` and pick its data path (may raise PageError,
        leaving the pool unchanged)."""
        pool = self.pool
        prompt = [int(t) for t in req.prompt]
        if req.out_tokens:  # resuming a preempted sequence
            table = pool.resume(req.req_id)
            if table is not None:
                if all(
                    pool.block(b).payload is not None for b in table.block_ids
                ):
                    return "restore"
                # blocks survived but carry no rows (non-pageable model):
                # drop the pins and rebuild the KV state through prefill
                pool.release(req.req_id, keep_resident=False)
            fed = prompt + [int(t) for t in req.out_tokens[:-1]]
            pool.allocate(req.req_id, fed)
            return "prefill-resume"
        if pageable and len(prompt) > 1 and pool.probe_restore(prompt[:-1]):
            # prefix-cache hit: KV rows for prompt[:-1] are all saved;
            # the last prompt token is fed through the normal decode step
            pool.allocate(req.req_id, prompt[:-1])
            return "restore"
        pool.allocate(req.req_id, prompt)
        return "prefill"

    def draft_depth(self, n_spec: int = 1) -> int:
        """Speculative draft depth for the next round: the configured
        ``draft_k``, or 0 (speculation shed) when the pool lacks headroom
        to absorb ``n_spec`` sequences each drafting k tokens — drafted
        positions allocate blocks just like committed ones, and spending
        the last free blocks on tokens that may be rolled back would force
        preemptions of committed work.  Cheap enough to consult mid-chain:
        a draft task re-checks between feeds and aborts its round if
        admission pressure arrived after the round started."""
        k = self.draft_k
        if k <= 0 or n_spec <= 0:
            return 0
        bs = self.pool.block_size
        need = n_spec * ((k + bs) // bs + 1)
        if self.pool.n_free + self.pool.n_evictable < need:
            return 0
        return k

    def preemption_victim(self, running: dict, exclude: int | None = None):
        """(slot, req) to preempt: youngest admission first; None if only the
        excluded slot is running."""
        candidates = [
            (slot, req) for slot, req in running.items() if slot != exclude
        ]
        if not candidates:
            return None
        return max(candidates, key=lambda kv: kv[1].admit_order)

    def stats(self) -> dict:
        return {
            "queue_depth": self.queue_depth,
            "max_queue": self.max_queue,
            "overload": self.overload,
            "max_batch": self.max_batch,
            "admit_max_wait": self.admit_max_wait,
            "draft_k": self.draft_k,
            "slot_occupancy": self.slot_occupancy,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "shed": self.shed,
            "deadline_shed": self.deadline_shed,
            "cancelled": self.cancelled,
            "preemptions": self.preemptions,
        }
