"""Continuous-batching serve engine on ONE persistent STF task graph.

A port of ``repro.serving.engine``.  Requests join and leave the decode batch
mid-flight — there is no generation-wide barrier.  Every engine iteration
inserts chained codelets into a single long-lived :class:`SpTaskGraph` owned
by the engine; the WRITE chain on the shared batch-state cell serialises what
must be serialised and nothing else:

    decode      write(state)  — one decode step + per-request sampling for
                                the whole batch
    collect     read(state)   — account fed tokens into the paged pool
                                (block appends, copy-on-write, preemption),
                                emit finished sequences, free slots
    prefill     write(out)    — prompt prefill for ONE admitted request;
                                touches no shared state, so it runs
                                concurrently with in-flight decode steps
    install     write(state, out)
                              — copy the prefilled KV into the slot, then
                                drop the prefill output
    restore     write(state)  — prefix-cache hit / resume: copy saved block
                                payloads in instead of recomputing

With a draft model (``draft_cfg=``) the graph runs under ``SP_MODEL_2`` and a
step whose batch holds a speculative request is one speculation round
instead of decode/collect: draft feeds chained as uncertain writers, a
verify, a commit (``spec.py``).

On the card the codelets launch the CUDA kernels (flash attention in
prefill, decode attention in decode, rmsnorm in both; for an ssm model the
ssd kernel in prefill and rmsnorm in both; an MLA model decodes in latent
space with torch ops; a hybrid runs flash and decode attention in its
attention layers only) from the engine's worker threads, each on its
thread's current stream.  The caches (one flat dict of leaves with the
batch slot on axis 1: KV rows, MLA's latent rows, ssm / rec states, a
hybrid's both) and the batch's last tokens live on the device and are
updated **in place**; per step there is one device→host copy (the sampled
tokens, in collect) and one host→device copy (the per-slot positions, in
decode).  MLA's latent rows page like KV rows.  An ssm or hybrid cache has
no per-token rows to page (``cache_layout`` is None): a duplicate prompt or
a preempted sequence is prefilled again.

Memory is managed by the paged KV cache (``kvcache.py``); admission control
and backpressure live in ``scheduler.py``.

Threading model: ``submit()`` is thread-safe; ``step()``/``run_until_drained``
must be driven from one thread (the planner mutates pool state with the
graph drained).
"""
from __future__ import annotations

import itertools
import math
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core import (
    SpComputeEngine,
    SpData,
    SpSpeculativeModel,
    SpTaskGraph,
    SpWorkerTeamBuilder,
    graph_scope,
    sp_task,
)
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import cache_layout, decode_step, init_cache, prefill
from repro_torch.models.transformer import refuse_model_axis
from repro_torch.models.config import ArchConfig
from repro_torch.runtime.serve import (
    concat_cache_rows,
    extract_cache_rows,
    insert_cache_rows,
    prime_cache,
)
from repro_torch.serving.kvcache import KVPagePool, PageError
from repro_torch.serving.scheduler import Admission, ServeScheduler

_req_ids = itertools.count()


@dataclass
class Request:
    """One serving request.  ``temperature == 0`` (default) decodes greedily;
    otherwise tokens are drawn from the temperature-scaled, top-k-filtered
    distribution with a random stream seeded from ``(seed, absolute
    position)`` — two runs with the same seed produce the same tokens, and
    re-decoding a position (preemption resume, a speculation round) redraws
    the same token.

    ``deadline`` is an absolute ``time.perf_counter()`` timestamp: once it
    passes, the request is shed from the queue or cancelled mid-decode
    (KV blocks released).  ``reject_reason`` says why a rejected request was
    turned away: ``"queue_full"``, ``"shed"``, or ``"deadline"``.

    ``speculative`` requests decode through draft/verify/commit rounds when
    the engine has a draft model; ``out_tokens``/``t_tokens``/``on_token``
    only ever see *committed* tokens."""

    prompt: np.ndarray  # (L,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0  # 0 = no top-k filter
    seed: int = 0
    deadline: Optional[float] = None  # absolute perf_counter seconds
    speculative: bool = False
    on_token: Optional[callable] = None  # per committed token, engine thread
    req_id: int = field(default_factory=lambda: next(_req_ids))
    out_tokens: list = field(default_factory=list)
    done: bool = False
    rejected: bool = False
    reject_reason: Optional[str] = None
    cancelled: bool = False
    # continuous-batching bookkeeping
    pending_tok: Optional[int] = None  # sampled (or prompt tail) token not yet fed
    admit_order: int = -1
    preemptions: int = 0
    # speculative-decoding telemetry
    spec_rounds: int = 0
    spec_accepted: int = 0
    # latency telemetry (perf_counter seconds)
    t_arrival: Optional[float] = None
    t_first: Optional[float] = None
    t_tokens: list = field(default_factory=list)

    def stream(self, poll: float = 0.001, timeout: Optional[float] = None):
        """Incremental iterator over committed tokens, returning when the
        request finishes.  Drive it from another thread than the engine loop."""
        i = 0
        t0 = time.perf_counter()
        while True:
            while i < len(self.out_tokens):
                yield self.out_tokens[i]
                i += 1
            if self.done:
                return
            if timeout is not None and time.perf_counter() - t0 > timeout:
                raise TimeoutError(f"request {self.req_id}: stream timed out")
            time.sleep(poll)

    def cancel(self) -> None:
        """Withdraw the request (any thread); acted on at the next
        scheduling point."""
        self.cancelled = True


# ---------------------------------------------------------------------------
# Codelets (``eng`` is the ServeEngine, bound as a static parameter).
# ---------------------------------------------------------------------------

@sp_task(write=("state",), name="serve.decode", cost=10.0)
def _decode_codelet(state, *, eng):
    if not eng._slot_req:
        return
    st = state.value
    eng._upload_positions()
    logits, caches = decode_step(eng.params, st["tok"], st["caches"], eng._pos, eng.cfg)
    toks = eng._sample_batch(logits[:, 0])
    state.value = {"caches": caches, "tok": toks[:, None]}
    eng.decode_steps += 1


@sp_task(read=("state",), name="serve.collect")
def _collect_codelet(state, *, eng):
    if not eng._slot_req:
        return
    toks = state["tok"][:, 0].cpu().numpy()  # the step's one device→host copy
    now = time.perf_counter()
    for slot in sorted(eng._slot_req):
        req = eng._slot_req.get(slot)
        if req is None:  # preempted as a victim earlier in this loop
            continue
        if req.cancelled:
            eng._cancel_slot(slot, reason=None)
            continue
        if req.deadline is not None and now > req.deadline:
            eng._cancel_slot(slot, reason="deadline")
            continue
        # the token decoded this step was ``pending_tok``; its KV row now
        # exists, so account it into the block table (may COW / preempt)
        try:
            eng.pool.append_token(req.req_id, req.pending_tok)
        except PageError:
            if not eng._preempt_for(slot):
                eng._preempt(slot)  # nothing else to preempt: park itself
                continue
            eng.pool.append_token(req.req_id, req.pending_tok)
        eng._pos_host[slot] += 1
        new = int(toks[slot])
        req.out_tokens.append(new)
        req.pending_tok = new
        if req.t_first is None:
            req.t_first = now
        req.t_tokens.append(now)
        eng._emit_token(req, new)
        if len(req.out_tokens) >= req.max_new_tokens or eng._pos_host[slot] >= eng.max_seq:
            eng._finish(slot)


@sp_task(write=("out",), name="serve.prefill", cost=5.0)
def _prefill_codelet(out, *, eng, req, sample_first):
    """Prefill one request.  No access to the shared batch state — it runs
    concurrently with whatever decode steps are in flight."""
    fed = req.prompt if sample_first else np.concatenate(
        [req.prompt, np.asarray(req.out_tokens[:-1], np.int32)]
    )
    tokens = torch.from_numpy(np.asarray(fed, np.int32)[None, :]).to(eng.device)
    logits, caches = prefill(eng.params, {"tokens": tokens}, eng.cfg)
    primed = prime_cache(eng.cfg, caches, tokens.shape[1], eng.max_seq)
    first = eng._sample_one(req, logits[0, -1]) if sample_first else None
    out.value = (primed, first, tokens.shape[1])


@sp_task(write=("state", "out"), name="serve.install")
def _install_codelet(state, out, *, eng, req, slot):
    """Copy the prefilled rows into the slot.  ``out`` is taken for writing
    only to release the primed cache once it is copied: the persistent graph
    keeps every task's cells, and a full-width primed cache is ~1 GB."""
    primed, first, n_fed = out.value
    out.value = None
    st = state.value
    if first is not None:
        req.out_tokens.append(first)
        req.pending_tok = first
        req.t_first = time.perf_counter()
        req.t_tokens.append(req.t_first)
        eng._emit_token(req, first)
    for name, full in st["caches"].items():
        full[:, slot] = primed[name][:, 0]
    st["tok"][slot, 0] = req.pending_tok
    eng._pos_host[slot] = n_fed
    eng._slot_req[slot] = req
    state.value = st
    if eng._spec is not None and req.speculative:
        eng._spec.prime_slot(slot, req)


@sp_task(write=("state",), name="serve.restore")
def _restore_codelet(state, *, eng, req, slot, rows, n_rows):
    """Prefix-cache hit / resume: copy saved KV rows into the slot and join
    the decode batch with no prefill at all."""
    st = state.value
    insert_cache_rows(st["caches"], slot, rows, 0)
    st["tok"][slot, 0] = req.pending_tok
    eng._pos_host[slot] = n_rows
    eng._slot_req[slot] = req
    state.value = st
    if eng._spec is not None and req.speculative:
        eng._spec.prime_slot(slot, req)


class ServeEngine:
    """Continuously-batched decoding server over a paged KV cache.

    ``params`` is the port's model (:func:`repro_torch.models.init_params`
    or :func:`repro_torch.bridge.params_from_numpy`) on ``device``, which
    defaults to ``"cuda"``; ``device="cpu"`` runs the plain PyTorch versions
    of the kernels.  ``draft_cfg`` / ``draft_params`` (a model on the same
    device, e.g. from :func:`~repro_torch.serving.spec.shrunken_draft`) and
    ``draft_k`` turn on speculative decoding.  Context manager: ``with
    ServeEngine(cfg, params) as eng: ...`` stops the owned compute engine on
    exit even if the body raises.
    """

    def __init__(
        self,
        cfg: ArchConfig,
        params,
        *,
        n_slots: int = 4,
        max_seq: int = 128,
        block_size: int = 8,
        n_blocks: Optional[int] = None,
        max_queue: int = 64,
        overload: str = "reject",
        max_batch: Optional[int] = None,
        admit_max_wait: float = 0.0,
        draft_cfg=None,
        draft_params=None,
        draft_k: int = 4,
        engine: Optional[SpComputeEngine] = None,
        device="cuda",
    ):
        refuse_model_axis(params, "ServeEngine")
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"model lives on {params.device}, engine asked for {self.device}")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        if n_blocks is None:
            n_blocks = n_slots * math.ceil(max_seq / block_size)
        self.pool = KVPagePool(n_blocks, block_size)
        self.scheduler = ServeScheduler(
            self.pool, n_slots, max_queue=max_queue, overload=overload,
            max_batch=max_batch, admit_max_wait=admit_max_wait,
            draft_k=draft_k if draft_cfg is not None else 0,
        )
        self._pageable = cache_layout(cfg) is not None
        self._slot_req: dict[int, Request] = {}
        # per-slot positions: the planner's host copy, uploaded once per
        # decode step into the (B,) int32 device tensor the kernel reads
        self._pos_host = np.zeros(n_slots, np.int32)
        pinned = self.device.type == "cuda"
        self._pos_staging = torch.zeros(n_slots, dtype=torch.int32, pin_memory=pinned)
        self._pos = torch.zeros(n_slots, dtype=torch.int32, device=self.device)
        self._caches = init_cache(cfg, n_slots, max_seq, device=self.device)
        self._own_engine = engine is None
        self.engine = engine or SpComputeEngine(SpWorkerTeamBuilder.team_of_cpu_workers(2))
        self._force_rollback = 0
        self.stream_errors = 0
        self.steps = 0
        self.decode_steps = 0
        self.prefills = 0
        self.restores = 0
        self.cancels = 0
        self.closed = False
        # ONE persistent graph for the engine's lifetime; every iteration
        # chains its codelets onto the same batch-state cell.  With a draft
        # model it runs under SP_MODEL_2, so speculation rounds (spec.py)
        # flow through the uncertain-writer chain machinery; the plain
        # decode path's certain writes clear any uncertainty at once.
        spec_model = (
            SpSpeculativeModel.SP_MODEL_2 if draft_cfg is not None
            else SpSpeculativeModel.SP_NO_SPEC
        )
        self._tg = SpTaskGraph(spec_model, trace=False).compute_on(self.engine)
        last_tok = torch.zeros((n_slots, 1), dtype=torch.int32, device=self.device)
        self._state = SpData({"caches": self._caches, "tok": last_tok}, "serve_state")
        self._spec = None
        if draft_cfg is not None:
            from repro_torch.serving.spec import SpecDecoder

            self._spec = SpecDecoder(self, draft_cfg, draft_params, k=draft_k)

    # ------------------------------------------------------------------ API

    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int = 16,
        *,
        temperature: float = 0.0,
        top_k: int = 0,
        seed: int = 0,
        deadline: Optional[float] = None,
        speculative: Optional[bool] = None,
        on_token: Optional[callable] = None,
    ) -> Request:
        """Enqueue a request (thread-safe).  Raises AdmissionError when the
        bounded queue is full under the ``"reject"`` overload policy.
        ``deadline`` is *relative* seconds from now.  ``speculative`` opts the
        request in or out of speculative decoding; the default (None) opts
        in iff the engine has a draft model.  ``on_token`` is invoked with
        each committed token as it lands (engine thread; exceptions are
        swallowed and counted in ``stream_errors``)."""
        if self.closed:
            raise RuntimeError("ServeEngine is closed")
        if speculative is None:
            speculative = self._spec is not None
        elif speculative and self._spec is None:
            raise ValueError(
                "speculative=True needs an engine with a draft model "
                "(ServeEngine(draft_cfg=, draft_params=))"
            )
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_seq ({self.max_seq})"
            )
        now = time.perf_counter()
        req = Request(
            prompt,
            max_new_tokens,
            temperature=float(temperature),
            top_k=int(top_k),
            seed=int(seed),
            deadline=None if deadline is None else now + float(deadline),
            speculative=bool(speculative),
            on_token=on_token,
        )
        req.t_arrival = now
        self.scheduler.submit(req)
        return req

    @property
    def n_running(self) -> int:
        return len(self._slot_req)

    def step(self, wait: bool = True) -> None:
        """One engine iteration: chain this iteration's codelets onto the
        persistent graph.  Decode/collect for the current batch go in first,
        then admissions — so a newly admitted request's prefill overlaps the
        in-flight decode and its KV installs right after collect.

        When a running request opted into speculation (and the scheduler's
        draft-depth policy allows it), decode/collect is replaced by one
        speculation round, which advances speculative slots by up to k+1
        committed tokens while plain slots ride along at one.  Rounds force
        ``wait``: round planning reads slot state the previous round must
        have committed."""
        spec_round = False
        with graph_scope(self._tg):
            if self._slot_req:
                spec_slots = [
                    s for s, r in self._slot_req.items() if r.speculative
                ] if self._spec is not None else []
                k = 0
                if spec_slots:
                    k = self.scheduler.draft_depth(len(spec_slots))
                    if k <= 0:
                        self._spec.sheds += 1  # pool pressure: plain decode
                if spec_slots and k > 0:
                    self._spec.insert_round(spec_slots, k)
                    spec_round = True
                else:
                    _decode_codelet(self._state, eng=self)
                    _collect_codelet(self._state, eng=self)
            for adm in self.scheduler.plan(pageable=self._pageable):
                self._insert_admission(adm)
        if wait or spec_round:
            self._tg.wait_all_tasks()
        self.steps += 1

    def run_until_drained(self, max_iters: int = 1000) -> None:
        """Pump until queue and batch are empty (not a barrier: submissions
        made while it runs are admitted mid-flight)."""
        it = 0
        while (self.scheduler.queue_depth or self._slot_req) and it < max_iters:
            self.step()
            it += 1
        if self.scheduler.queue_depth or self._slot_req:
            raise RuntimeError("serve loop did not drain")

    def stats(self) -> dict:
        out = {
            "steps": self.steps,
            "decode_steps": self.decode_steps,
            "prefills": self.prefills,
            "restores": self.restores,
            "cancels": self.cancels,
            "running": self.n_running,
            "pageable": self._pageable,
            "stream_errors": self.stream_errors,
        }
        out.update(self.scheduler.stats())
        out["pool"] = self.pool.stats()
        if self._spec is not None:
            out["spec"] = self._spec.stats()
            out["spec"]["graph"] = dict(self._tg.spec_stats)
        return out

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if self._own_engine:
            self.engine.stop()

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # ----------------------------------------------------------------- inner

    def _upload_positions(self) -> None:
        """Host positions → the device (B,) tensor, through a pinned buffer on
        the card.  The previous step's copy has completed: collect's (or the
        verify body's) device→host token copy came after it on the same
        stream."""
        self._pos_staging.copy_(torch.from_numpy(self._pos_host))
        self._pos.copy_(self._pos_staging, non_blocking=True)

    def _insert_admission(self, adm: Admission) -> None:
        req, slot, mode = adm.req, adm.slot, adm.mode
        if mode == "restore":
            table = self.pool.table_of(req.req_id)
            payloads = [self.pool.block(b).payload for b in table.block_ids]
            rows = concat_cache_rows(payloads)
            if not req.out_tokens:
                # fresh request via prefix cache: rows cover prompt[:-1];
                # the final prompt token rides the normal decode step
                req.pending_tok = int(req.prompt[-1])
            _restore_codelet(
                self._state, eng=self, req=req, slot=slot,
                rows=rows, n_rows=table.n_tokens,
            )
            self.restores += 1
        else:
            out = SpData(None, f"prefill.{req.req_id}")
            _prefill_codelet(out, eng=self, req=req, sample_first=(mode == "prefill"))
            _install_codelet(self._state, out, eng=self, req=req, slot=slot)
            self.prefills += 1

    def _writeback(self, slot: int, req: Request) -> None:
        """Save the slot's computed KV rows into the block payloads so a
        later prefix hit / resume can restore instead of re-prefilling.  The
        rows come to the host in one copy and are sliced per block."""
        if not self._pageable:
            return
        table = self.pool.table_of(req.req_id)
        if table is None:
            return
        bs = self.pool.block_size
        rows = None
        for i, bid in enumerate(table.block_ids):
            blk = self.pool.block(bid)
            a = i * bs
            b = min(a + len(blk.tokens), table.n_tokens)
            if blk.payload is None or blk.refcount <= 1:
                if rows is None:
                    rows = extract_cache_rows(self._caches, slot, 0, table.n_tokens)
                blk.payload = {k: v[:, a:b] for k, v in rows.items()}

    def _emit_token(self, req: Request, tok: int) -> None:
        """Fire the streaming callback for one committed token."""
        if req.on_token is None:
            return
        try:
            req.on_token(tok)
        except Exception:
            self.stream_errors += 1

    def force_rollback(self, n: int = 1) -> None:
        """Poison the next ``n`` speculation rounds: their draft chains
        write the state cell, so the machinery rolls the verify back and
        re-executes it as a plain decode.  Output is unchanged (that is the
        point of the commit/rollback protocol); used by tests and chaos
        schedules."""
        if self._spec is None:
            raise RuntimeError("engine has no draft model; nothing to roll back")
        self._force_rollback += int(n)

    def _finish(self, slot: int) -> None:
        req = self._slot_req.pop(slot)
        req.done = True
        self._writeback(slot, req)
        self.pool.release(req.req_id, keep_resident=True)
        self.scheduler.free_slot(slot)
        if self._spec is not None:
            self._spec.drop_slot(slot)

    def _cancel_slot(self, slot: int, *, reason: Optional[str]) -> None:
        """Evict a running sequence whose output is no longer wanted: its KV
        blocks are freed immediately and the slot rejoins the free list."""
        req = self._slot_req.pop(slot)
        req.done = True
        if reason is not None:
            req.rejected = True
            req.reject_reason = reason
        self.pool.release(req.req_id, keep_resident=False)
        self.scheduler.free_slot(slot)
        self.cancels += 1
        if self._spec is not None:
            self._spec.drop_slot(slot)

    def _preempt(self, slot: int) -> None:
        """Evict a running sequence: save its KV rows, release its blocks
        (resumable), and requeue it at the head of the admission queue."""
        req = self._slot_req.pop(slot)
        self._writeback(slot, req)
        self.pool.release(req.req_id, keep_resident=True)
        self.scheduler.free_slot(slot)
        req.preemptions += 1
        self.scheduler.requeue(req)
        if self._spec is not None:
            self._spec.drop_slot(slot)

    def _preempt_for(self, needy_slot: int) -> bool:
        victim = self.scheduler.preemption_victim(self._slot_req, exclude=needy_slot)
        if victim is None:
            return False
        self._preempt(victim[0])
        return True

    # -------------------------------------------------------------- sampling

    def _sample_batch(self, logits: torch.Tensor) -> torch.Tensor:
        """Per-slot sampling: greedy unless the slot's request asks for
        temperature/top-k, each with a uniform draw keyed by the request's
        seed and the *absolute position* of the token being sampled."""
        reqs = self._slot_req
        if all(r.temperature <= 0.0 for r in reqs.values()):
            return torch.argmax(logits, dim=-1).to(torch.int32)
        B = logits.shape[0]
        temps = np.zeros(B, np.float32)
        topks = np.zeros(B, np.int32)
        u = np.zeros(B, np.float32)
        for slot, r in reqs.items():
            temps[slot] = r.temperature
            topks[slot] = r.top_k
            if r.temperature > 0.0:
                u[slot] = position_uniform(r.seed, len(r.prompt) + len(r.out_tokens))
        return sample_logits(logits, *(torch.from_numpy(a).to(logits.device) for a in (temps, topks, u)))

    def _sample_one(self, req: Request, logits: torch.Tensor) -> int:
        if req.temperature <= 0.0:
            return int(torch.argmax(logits))
        u = position_uniform(req.seed, len(req.prompt) + len(req.out_tokens))
        dev = logits.device
        tok = sample_logits(
            logits[None, :],
            torch.tensor([req.temperature], dtype=torch.float32, device=dev),
            torch.tensor([req.top_k], dtype=torch.int32, device=dev),
            torch.tensor([u], dtype=torch.float32, device=dev),
        )
        return int(tok[0])


_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def position_uniform(seed: int, position: int) -> float:
    """One uniform in [0, 1) from a ``torch.Generator`` seeded by the pair
    (request seed, absolute token position) — the port's counterpart of
    ``jax.random.fold_in(PRNGKey(seed), position)``.  The pair is mixed
    (splitmix64) because the CPU generator keeps only the seed's low bits."""
    key = _splitmix64(_splitmix64(seed & _M64) ^ (position & _M64))
    gen = torch.Generator().manual_seed(key)
    return float(torch.rand((), generator=gen))


def sample_logits(logits, temps, topks, u) -> torch.Tensor:
    """Batched sampling: temperature scaling + top-k filter + inverse-CDF
    draw at the uniforms ``u``, argmax where ``temps == 0``.
    (B, V) → (B,) int32."""
    V = logits.shape[-1]
    lf = logits.float()
    greedy = torch.argmax(lf, dim=-1)
    scaled = lf / torch.clamp(temps, min=1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = torch.clamp(torch.where(topks > 0, topks, V) - 1, 0, V - 1).long()
    thresh = torch.gather(sorted_desc, -1, k_idx[:, None])
    masked = scaled.masked_fill(scaled < thresh, float("-inf"))
    cdf = torch.cumsum(torch.softmax(masked, dim=-1), dim=-1)
    target = (u * cdf[:, -1])[:, None].contiguous()
    sampled = torch.clamp(torch.searchsorted(cdf, target, right=True)[:, 0], max=V - 1)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)
