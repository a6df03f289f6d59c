"""Speculative decoding on the runtime's commit/rollback speculation engine.

A port of ``repro.serving.spec``.  A chain of *uncertain writers*
(``maybe``-write accesses) shares one snapshot under ``SP_MODEL_2``; a reader
of the uncertain cell is rewritten into a speculative body that runs on the
snapshot plus a commit task that either promotes the speculative result (no
writer wrote) or re-executes the body on the real value (rollback).  Draft
model speculative decoding maps onto that machinery (see the "Speculative
decoding" section of ``core/speculation.py``):

* ``spec.draft`` (×k) — one draft-model decode step per task, chained as
  ``maybe``-writers on the engine's batch-state cell.  Normally a draft never
  writes the state (drafted tokens are *proposals*); when speculation must be
  abandoned mid-chain (pool pressure shed, forced rollback) it *does* write,
  poisoning the chain.
* ``spec.verify`` — reads the uncertain state cell, so the machinery turns
  it into a speculative body + commit task.  The body runs ONE multi-position
  target forward (``models.verify_step``) over the pending token and the k
  drafted positions, samples the target's token at every position, and
  accepts the longest matching draft prefix plus one bonus token.  The
  machinery may run it twice: speculatively, and again on rollback (where it
  sees ``round.abort`` and degrades to a plain one-token decode).
* ``spec.commit`` — a *certain* write on the state cell: installs the
  advanced state (tearing down the uncertainty chain for the next round) and
  performs every externally visible effect exactly once — pool block
  appends, ``out_tokens``, streaming callbacks, staged-payload promotion.

Greedy verification is bit-exact with plain decode: ``verify_step`` is
``decode_step`` unrolled at the plain decode's shapes, and only
target-sampled tokens are ever committed.  Sampling is exact too: the
uniform of the token at absolute index ``i`` is ``position_uniform(seed,
i)`` on every path, so a position samples identically whatever rounds,
rollbacks or preemptions preceded it.

**Aliasing.**  ``repro``'s snapshot is a reference to immutable arrays.  The
port's state holds mutable tensors, and ``decode_step`` writes the KV cache
in place, so the snapshot, the live state and the verify body's "new" caches
are one set of tensors.  The port is correct because every in-place write of
the verify body meets one of two conditions:

1. it is at or beyond the slot's committed position ``P`` (rows ``P..P+k``
   of a speculating slot): the per-slot causal mask (rows ``<= pos``) hides
   it from every committed computation until the row is written again by
   the decode that commits that position; or
2. it rewrites row ``P`` with the token already pending there — what a
   plain rider (``advance = 0``) does at each sub-step, and what both runs of
   an aborted round (the speculative body and its rollback, ``T = 1`` at
   ``P``) do: the same token at the same row gives the same bits.

The body's other outputs are fresh: the token tensor is new (the rollback
re-reads the old one), and staged rows are host copies.  A slot whose
``P + k`` would pass the cache's last row rides the round as a plain decode
(``repro`` drops such writes silently, a CUDA index asserts); its stream is
unchanged.

Draft KV state: the draft model keeps its own dense cache per slot,
self-healed across rounds — rows written for rejected drafts sit beyond the
committed cursor, where the causal mask hides them until the row is
overwritten.  Both target and draft must have per-token KV rows
(``cache_layout(cfg) is not None``): a recurrent state cannot rewind.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from repro_torch.core import SpData, sp_task
from repro_torch.models import Transformer, cache_layout, decode_step, init_cache, prefill
from repro_torch.runtime.serve import build_verify_fn, extract_cache_rows, prime_cache
from repro_torch.serving.engine import position_uniform, sample_logits
from repro_torch.serving.kvcache import PageError


def shrunken_draft(cfg, model=None, *, n_layers: int = 1):
    """Default draft preset: the target config truncated to its first
    ``n_layers`` layers (same vocab, family and cache geometry).  With
    ``model`` given, the draft is a :class:`Transformer` that *shares* the
    target's embedding, head, final norm and first ``n_layers`` layer modules
    (no copy) — a free low-quality draft.  → (draft_cfg, draft_model)."""
    draft_cfg = cfg.replace(n_layers=n_layers)
    if cache_layout(draft_cfg) is None:
        raise ValueError(
            f"family {cfg.family!r} has no per-token KV rows to rewind; "
            "speculative drafting needs cache_layout(cfg) is not None"
        )
    if model is None:
        return draft_cfg, None
    if not 1 <= n_layers <= len(model.layers):
        raise ValueError(f"n_layers {n_layers} not in [1, {len(model.layers)}]")
    draft = Transformer.__new__(Transformer)
    nn.Module.__init__(draft)
    draft.cfg = draft_cfg
    for name, p in model.named_parameters(recurse=False):  # embedding, unembed
        draft.register_parameter(name, p)
    draft.layers = nn.ModuleList(model.layers[:n_layers])
    draft.final_norm = model.final_norm
    return draft_cfg, draft


@dataclass
class _RoundSlot:
    """Per-slot drafting state for one speculation round."""

    P: int                    # verify anchor: the slot's position at round start
    queue: list               # committed-but-unfed draft tokens, pending last
    dp: int                   # next draft-cache feed position
    proposals: list = field(default_factory=list)
    last_tok: int = 0
    fed_log: list = field(default_factory=list)  # [(pos, tok)] feeds performed


@dataclass
class SpecRound:
    """One speculation round: k draft feeds chained as uncertain writers,
    one verify, one commit.  ``abort`` flips when a draft poisons the chain
    (shed / forced rollback) — the machinery then rolls the verify back."""

    k: int
    per_slot: dict = field(default_factory=dict)  # slot -> _RoundSlot
    n_feeds: int = 0
    abort: bool = False


# ---------------------------------------------------------------------------
# Codelets (``eng``/``rnd`` are static parameters; data slots carry the
# engine's batch-state cell plus two per-round cells).
# ---------------------------------------------------------------------------

@sp_task(maybe=("state",), write=("prop",), name="spec.draft", cost=2.0)
def _draft_codelet(state, prop, *, eng, rnd, j):
    """One draft-model decode feed.  ``maybe``-write on the batch state:
    normally it never assigns (drafts are proposals, committed only by
    ``spec.commit``); on shed/forced-rollback it poisons the chain so the
    machinery re-executes the verify on the real state."""
    if not rnd.abort and (
        eng._force_rollback > 0
        or eng.scheduler.draft_depth(len(rnd.per_slot)) <= 0
    ):
        rnd.abort = True
    if rnd.abort:
        state.value = state.value  # uncertain write -> machinery rollback
    else:
        eng._spec._draft_feed(rnd)
    prop.value = j


@sp_task(read=("state", "prop"), write=("vout",), name="spec.verify", cost=10.0)
def _verify_codelet(state, prop, vout, *, eng, rnd):
    """Speculated reader of the uncertain state cell; may run twice
    (speculatively, then on rollback): all engine effects live in
    ``spec.commit``."""
    vout.value = eng._spec._verify(rnd, state)


@sp_task(write=("state",), read=("vout",), name="spec.commit")
def _commit_codelet(state, vout, *, eng, rnd):
    """Certain write on the state cell: installs the advanced batch state
    (clearing the uncertainty chain) and applies all external effects."""
    eng._spec._commit(rnd, vout, state)


class SpecDecoder:
    """Draft-model speculative decoding bolted onto a :class:`ServeEngine`.

    Owns the draft model, its per-slot KV cache on the engine's device, and
    the round lifecycle.  The engine consults it from ``step()`` when any
    running request opted into speculation.
    """

    def __init__(self, eng, draft_cfg, draft_params, k: int = 4):
        if k < 1:
            raise ValueError("draft depth k must be >= 1")
        if cache_layout(eng.cfg) is None:
            raise ValueError(
                "speculative decoding needs a pageable target family "
                "(cache_layout(cfg) is not None): stale KV rows beyond the "
                "accepted position must be maskable and overwritable"
            )
        if cache_layout(draft_cfg) is None:
            raise ValueError("draft family must have per-token KV rows too")
        if draft_cfg.vocab != eng.cfg.vocab:
            raise ValueError(
                f"draft vocab {draft_cfg.vocab} != target vocab {eng.cfg.vocab}"
            )
        if draft_params is None:
            raise ValueError("a draft model (draft_params) is required")
        if draft_params.device.type != eng.device.type:
            raise ValueError(f"draft model lives on {draft_params.device}, engine on {eng.device}")
        self.eng = eng
        self.cfg = draft_cfg
        self.params = draft_params
        self.k = int(k)
        self._caches = init_cache(draft_cfg, eng.n_slots, eng.max_seq, device=eng.device)
        self._verify_fn = build_verify_fn(eng.cfg)
        self._next_pos: dict[int, int] = {}  # slot -> draft rows valid below
        # slot -> (start, rows): committed verify rows carried across rounds
        # so blocks that straddle a round boundary can still be promoted
        self._staged_tail: dict[int, tuple] = {}
        self.rounds = 0
        self.rollback_rounds = 0
        self.sheds = 0
        self.proposed = 0
        self.accepted = 0
        self.committed_tokens = 0
        self.draft_feeds = 0
        self.staged_promotions = 0

    # -------------------------------------------------------------- lifecycle

    def prime_slot(self, slot: int, req) -> None:
        """Build the draft model's KV rows for everything the target has
        already fed in this slot (admission, restore, preemption resume):
        one draft prefill, copied into the slot, then released."""
        n = int(self.eng._pos_host[slot])
        if n >= 1:
            full = [int(t) for t in req.prompt] + [int(t) for t in req.out_tokens]
            toks = torch.from_numpy(np.asarray(full[:n], np.int32)[None, :]).to(self.eng.device)
            _, caches = prefill(self.params, {"tokens": toks}, self.cfg)
            primed = prime_cache(self.cfg, caches, n, self.eng.max_seq)
            del caches
            for name, c in self._caches.items():
                c[:, slot] = primed[name][:, 0]
            del primed
        self._next_pos[slot] = n

    def drop_slot(self, slot: int) -> None:
        self._next_pos.pop(slot, None)
        self._staged_tail.pop(slot, None)

    def insert_round(self, spec_slots: list, k: int) -> SpecRound:
        """Chain one round's draft/verify/commit codelets onto the engine's
        graph (caller holds ``graph_scope``)."""
        eng = self.eng
        rnd = SpecRound(k=k)
        for slot in spec_slots:
            req = eng._slot_req[slot]
            full = [int(t) for t in req.prompt] + [int(t) for t in req.out_tokens]
            P = int(eng._pos_host[slot])
            npos = min(self._next_pos.get(slot, 0), P)
            rnd.per_slot[slot] = _RoundSlot(P=P, queue=full[npos:P + 1], dp=npos)
        rnd.n_feeds = max(len(s.queue) - 1 for s in rnd.per_slot.values()) + k
        prop = SpData(None, f"spec.prop.{eng.steps}")
        vout = SpData(None, f"spec.vout.{eng.steps}")
        for j in range(rnd.n_feeds):
            _draft_codelet(eng._state, prop, eng=eng, rnd=rnd, j=j)
        _verify_codelet(eng._state, prop, vout, eng=eng, rnd=rnd)
        _commit_codelet(eng._state, vout, eng=eng, rnd=rnd)
        return rnd

    # --------------------------------------------------------------- drafting

    def _draft_feed(self, rnd: SpecRound) -> None:
        """One batched draft decode step.  Each spec slot feeds its next
        token — catch-up (committed but not yet in the draft cache), the
        pending token, or its own last proposal — at its own position; a
        slot already holding k proposals re-feeds its last token at the
        same position (an idempotent KV row rewrite)."""
        eng = self.eng
        B = eng.n_slots
        toks = np.zeros((B, 1), np.int32)
        pos = np.zeros(B, np.int32)
        gen = {}
        for slot, s in rnd.per_slot.items():
            if s.queue:
                t = s.queue.pop(0)
                p, s.dp = s.dp, s.dp + 1
                gen[slot] = not s.queue and len(s.proposals) < rnd.k
                s.fed_log.append((p, t))
            elif len(s.proposals) < rnd.k:
                t = s.proposals[-1]
                p, s.dp = s.dp, s.dp + 1
                gen[slot] = True
                s.fed_log.append((p, t))
            else:
                t, p = s.last_tok, s.dp - 1  # idempotent re-feed
                gen[slot] = False
            s.last_tok = t
            toks[slot, 0] = t
            pos[slot] = min(p, eng.max_seq - 1)
        dev = eng.device
        logits, self._caches = decode_step(
            self.params, torch.from_numpy(toks).to(dev), self._caches,
            torch.from_numpy(pos).to(dev), self.cfg,
        )
        self.draft_feeds += 1
        arg = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        for slot, s in rnd.per_slot.items():
            if gen[slot]:
                s.proposals.append(int(arg[slot]))

    # ------------------------------------------------------------ verify body

    def _verify(self, rnd: SpecRound, st) -> dict:
        """One batched multi-position target forward + per-position target
        sampling + acceptance.  Its cache writes obey the aliasing contract
        of the module docstring; it may run twice (speculative body, then
        rollback re-execution)."""
        eng = self.eng
        B = eng.n_slots
        tok0 = st["tok"].cpu().numpy()  # the body's one device→host copy of the state
        adv = np.zeros(B, np.int32)
        if rnd.abort:
            T = 1
            toks = tok0
        else:
            T = rnd.k + 1
            toks = np.repeat(tok0, T, axis=1)
            for slot, s in rnd.per_slot.items():
                if s.P + rnd.k < eng.max_seq:  # else: a plain rider this round
                    adv[slot] = 1
                    toks[slot, 1:1 + len(s.proposals)] = s.proposals
        eng._upload_positions()  # the round's anchors P, from the host copy
        dev = eng.device
        logits, new_caches = self._verify_fn(
            eng.params, torch.from_numpy(toks).to(dev), st["caches"], eng._pos,
            torch.from_numpy(adv).to(dev),
        )
        tgt = self._sample_positions(logits, T)
        new_tok = tok0.copy()
        per = {}
        for slot, req in eng._slot_req.items():
            s = rnd.per_slot.get(slot) if adv[slot] else None
            if s is None:
                nxt = int(tgt[slot, 0])
                per[slot] = {
                    "fed": [int(tok0[slot, 0])], "out": [nxt], "accepted": 0,
                }
                new_tok[slot, 0] = nxt
                continue
            a = 0
            while a < rnd.k and int(tgt[slot, a]) == s.proposals[a]:
                a += 1
            out = [int(t) for t in tgt[slot, : a + 1]]
            per[slot] = {
                "fed": [int(tok0[slot, 0])] + s.proposals[:a],
                "out": out,
                "accepted": a,
            }
            new_tok[slot, 0] = out[-1]
            if eng._pageable:
                # the k+1 freshly computed target KV rows are *uncommitted*
                # until spec.commit promotes the accepted prefix
                stop = min(s.P + rnd.k + 1, eng.max_seq)
                rows = extract_cache_rows(new_caches, slot, s.P, stop)
                eng.pool.stage_rows(req.req_id, s.P, rows)
        return {
            "abort": rnd.abort,
            "state": {"caches": new_caches, "tok": torch.from_numpy(new_tok).to(dev)},
            "per": per,
        }

    def _sample_positions(self, logits: torch.Tensor, T: int) -> np.ndarray:
        """Target tokens (B, T) for every (slot, sub-step): greedy argmax,
        or the engine's sampler at the uniform the plain decode path draws
        for that token's absolute index (``position_uniform``)."""
        eng = self.eng
        reqs = eng._slot_req
        if all(r.temperature <= 0.0 for r in reqs.values()):
            return torch.argmax(logits, dim=-1).cpu().numpy()
        B = logits.shape[0]
        temps = np.zeros(B, np.float32)
        topks = np.zeros(B, np.int32)
        for slot, r in reqs.items():
            temps[slot] = r.temperature
            topks[slot] = r.top_k
        dev = logits.device
        temps_d, topks_d = torch.from_numpy(temps).to(dev), torch.from_numpy(topks).to(dev)
        cols = []
        for t in range(T):
            u = np.zeros(B, np.float32)
            for slot, r in reqs.items():
                if r.temperature > 0.0:
                    u[slot] = position_uniform(r.seed, len(r.prompt) + len(r.out_tokens) + t)
            # contiguous, as the plain step's (B, V) logits are
            cols.append(sample_logits(logits[:, t].contiguous(), temps_d, topks_d,
                                      torch.from_numpy(u).to(dev)))
        return torch.stack(cols, dim=1).cpu().numpy()

    # ------------------------------------------------------------ commit body

    def _commit(self, rnd: SpecRound, v: dict, state) -> None:
        """All externally visible effects of the round, applied exactly
        once: install the advanced state (certain write → chain teardown),
        account fed tokens into the pool, append committed tokens, fire
        streaming callbacks, promote staged KV payloads, finish/cancel."""
        eng = self.eng
        self.rounds += 1
        if v["abort"]:
            self.rollback_rounds += 1
            if eng._force_rollback > 0:
                eng._force_rollback -= 1
        state.value = v["state"]
        eng._caches = v["state"]["caches"]
        now = time.perf_counter()
        for slot in sorted(eng._slot_req):
            req = eng._slot_req.get(slot)
            if req is None:  # preempted as a victim earlier in this loop
                continue
            if req.cancelled:
                eng.pool.drop_staged(req.req_id)
                eng._cancel_slot(slot, reason=None)
                continue
            if req.deadline is not None and now > req.deadline:
                eng.pool.drop_staged(req.req_id)
                eng._cancel_slot(slot, reason="deadline")
                continue
            info = v["per"][slot]
            s = rnd.per_slot.get(slot)
            if s is not None and not v["abort"]:
                self.proposed += rnd.k
                self.accepted += info["accepted"]
                req.spec_rounds += 1
                req.spec_accepted += info["accepted"]
            alive = True
            for ftok, ntok in zip(info["fed"], info["out"]):
                try:
                    eng.pool.append_token(req.req_id, ftok)
                except PageError:
                    if not eng._preempt_for(slot):
                        eng._preempt(slot)
                        alive = False
                        break
                    eng.pool.append_token(req.req_id, ftok)
                eng._pos_host[slot] += 1
                req.out_tokens.append(int(ntok))
                req.pending_tok = int(ntok)
                if req.t_first is None:
                    req.t_first = now
                req.t_tokens.append(now)
                eng._emit_token(req, int(ntok))
                self.committed_tokens += 1
                if (len(req.out_tokens) >= req.max_new_tokens
                        or eng._pos_host[slot] >= eng.max_seq):
                    self._promote_staged(slot, req)
                    eng._finish(slot)
                    alive = False
                    break
            if not alive:
                continue
            self._promote_staged(slot, req)
            if s is not None:
                self._advance_draft_cursor(slot, req, s)

    def _advance_draft_cursor(self, slot: int, req, s: _RoundSlot) -> None:
        """Draft rows are valid up to the first fed token that disagrees
        with the committed sequence (rejected proposals leave stale rows,
        self-healed by later overwrites)."""
        full = [int(t) for t in req.prompt] + [int(t) for t in req.out_tokens]
        cur = self._next_pos.get(slot, 0)
        for p, t in s.fed_log:
            if p < cur:
                continue  # idempotent re-feed of an already-valid row
            if p == cur and p < len(full) and full[p] == t:
                cur += 1
            else:
                break
        self._next_pos[slot] = cur

    def _promote_staged(self, slot: int, req) -> None:
        """Move accepted uncommitted KV rows into block payloads: any block
        that fills up with committed rows becomes payload-backed immediately
        (restorable without waiting for the finish-time writeback).  The
        committed trailing rows of each round are retained and merged into
        the next round's window, so a block that straddles a round boundary
        is still promoted once its last row lands.  Staged rows are host
        copies; payloads are views of them, never of a live cache."""
        eng = self.eng
        st = eng.pool.take_staged(req.req_id)
        if st is None or not eng._pageable:
            return
        start, rows = st
        n_rows = next(iter(rows.values())).shape[1]
        # rows past the committed position came from rejected proposals:
        # their tokens are not what will occupy those positions
        end = min(start + n_rows, int(eng._pos_host[slot]))
        if end <= start:
            self._staged_tail.pop(slot, None)
            return
        tail = self._staged_tail.pop(slot, None)
        if tail is not None:
            t_start, t_rows = tail
            t_end = t_start + next(iter(t_rows.values())).shape[1]
            if t_start < start <= t_end:  # contiguous: prepend retained rows
                keep = start - t_start
                rows = {k: torch.cat([t_rows[k][:, :keep], r], dim=1) for k, r in rows.items()}
                start = t_start
        table = eng.pool.table_of(req.req_id)
        if table is None:
            return
        bs = eng.pool.block_size
        for i, bid in enumerate(table.block_ids):
            blk = eng.pool.block(bid)
            a, b = i * bs, i * bs + len(blk.tokens)
            if (blk.full and blk.payload is None
                    and a >= start and b <= end):
                blk.payload = {k: t[:, a - start:b - start] for k, t in rows.items()}
                self.staged_promotions += 1
        # carry the committed rows of the still-partial trailing block
        t_start = max(start, (end // bs) * bs)
        if t_start < end:
            self._staged_tail[slot] = (
                t_start, {k: t[:, t_start - start:end - start] for k, t in rows.items()},
            )

    # ------------------------------------------------------------------ stats

    def stats(self) -> dict:
        return {
            "draft_k": self.k,
            "rounds": self.rounds,
            "rollback_rounds": self.rollback_rounds,
            "sheds": self.sheds,
            "draft_feeds": self.draft_feeds,
            "proposed": self.proposed,
            "accepted": self.accepted,
            "accept_rate": self.accepted / max(self.proposed, 1),
            "committed_tokens": self.committed_tokens,
            "accepted_per_round": self.committed_tokens / max(self.rounds, 1),
            "staged_promotions": self.staged_promotions,
        }
