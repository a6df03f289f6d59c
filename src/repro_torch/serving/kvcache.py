"""Paged KV cache — fixed-size blocks, free-list reuse, prefix sharing with
copy-on-write, and deterministic block-granularity LRU eviction.

This is the serving tier's software-managed memory level (paper §4.3: "we
employ the Least Recently Used policy to determine which memory blocks
should be evicted from the devices when they are full"), promoted from the
old one-slot-per-sequence pool to real paging:

* **Blocks** — every sequence's KV state is accounted in fixed-size blocks
  of ``block_size`` tokens.  The pool holds at most ``n_blocks`` live
  blocks; block ids are never reused, so a stale block table cannot alias a
  recycled block.

* **Block tables** — each sequence maps to an ordered list of block ids
  (:class:`BlockTable`).  ``table.n_tokens`` counts the tokens whose KV
  rows exist (tokens *fed* to the model, not tokens merely sampled).

* **Prefix sharing** — full blocks are content-addressed by a chain key
  (the token contents of every block before them plus their own), so two
  sequences with a common prompt prefix reference the *same* blocks with a
  refcount.  A partial tail block is shared only on an exact content match.
  Appending to a shared partial block triggers **copy-on-write**: the
  appender gets a private copy, the other referents keep the original.

* **LRU eviction** — when a new block is needed and the pool is full, the
  least-recently-used block with ``refcount == 0`` (released or resident
  sequences) is evicted.  Recency is a monotonically increasing use counter
  stamped on every touch — not a wall-clock timestamp — so eviction order
  is deterministic under test and equal-time touches cannot tie.

* **Payloads** — each block may carry an opaque payload (the engine stores
  the block's KV rows, as CPU tensors, at writeback time).  A future
  request whose prompt is fully covered by payload-backed blocks restores
  the rows instead of re-running prefill; an evicted block drops its
  payload, so an evict-then-resume goes back through prefill.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional, Sequence


class PageError(RuntimeError):
    """The pool cannot satisfy an allocation (every block is pinned)."""


#: Chain key of the empty prefix (the root of the content-addressed trie).
_ROOT = ("kv-root",)


@dataclass
class KVBlock:
    """One fixed-capacity block of cached tokens.

    ``parent_key`` is the chain key of the prefix before this block;
    ``key`` (parent_key, own tokens) content-addresses the block.  The
    ``payload`` slot is opaque to the pool — the engine stores extracted
    KV rows there so a prefix hit can skip prefill.
    """

    block_id: int
    capacity: int
    tokens: list[int]
    parent_key: Any
    refcount: int = 1
    stamp: int = 0
    payload: Any = None

    @property
    def full(self) -> bool:
        return len(self.tokens) >= self.capacity

    @property
    def key(self) -> tuple:
        return (self.parent_key, tuple(self.tokens))


@dataclass
class BlockTable:
    """Ordered block ids of one sequence + the number of KV rows present."""

    seq_id: int
    block_ids: list[int] = field(default_factory=list)
    n_tokens: int = 0


class KVPagePool:
    """Fixed-budget paged KV pool: free-list allocation, prefix sharing with
    refcounts and copy-on-write, deterministic LRU eviction of unreferenced
    blocks.  Pure bookkeeping + payload store — tensor movement is the
    engine's job (``serving/engine.py``)."""

    def __init__(self, n_blocks: int, block_size: int = 16):
        if n_blocks < 1 or block_size < 1:
            raise ValueError("n_blocks and block_size must be >= 1")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._blocks: dict[int, KVBlock] = {}
        self._tables: dict[int, BlockTable] = {}     # actively decoding
        self._resident: dict[int, BlockTable] = {}   # released, resumable
        self._full_index: dict[tuple, int] = {}      # chain key -> block id
        self._partial_index: dict[Any, list[int]] = {}  # parent key -> ids
        self._ids = itertools.count()
        self._use = itertools.count(1)  # deterministic LRU clock
        self._staged: dict[int, tuple] = {}  # seq -> (start, rows), uncommitted
        self.evictions = 0
        self.shared_hits = 0
        self.cow_copies = 0
        self.allocated_blocks = 0
        self.staged_rounds = 0
        self.staged_drops = 0

    # ------------------------------------------------------------- internals

    def _touch(self, blk: KVBlock) -> None:
        blk.stamp = next(self._use)

    def _index_add(self, blk: KVBlock) -> None:
        if blk.full:
            self._full_index.setdefault(blk.key, blk.block_id)
        else:
            self._partial_index.setdefault(blk.parent_key, []).append(blk.block_id)

    def _index_remove(self, blk: KVBlock) -> None:
        if blk.full:
            if self._full_index.get(blk.key) == blk.block_id:
                del self._full_index[blk.key]
        else:
            bucket = self._partial_index.get(blk.parent_key)
            if bucket and blk.block_id in bucket:
                bucket.remove(blk.block_id)
                if not bucket:
                    del self._partial_index[blk.parent_key]

    def _drop_block(self, blk: KVBlock) -> None:
        self._index_remove(blk)
        del self._blocks[blk.block_id]
        blk.payload = None

    def _evict_one(self) -> bool:
        candidates = [b for b in self._blocks.values() if b.refcount == 0]
        if not candidates:
            return False
        victim = min(candidates, key=lambda b: b.stamp)
        self._drop_block(victim)
        self.evictions += 1
        return True

    def _new_block(self, tokens: Iterable[int], parent_key: Any) -> KVBlock:
        while len(self._blocks) >= self.n_blocks:
            if not self._evict_one():
                raise PageError(
                    f"KV pool exhausted: all {self.n_blocks} blocks referenced "
                    f"by active sequences"
                )
        blk = KVBlock(next(self._ids), self.block_size, list(tokens), parent_key)
        self._touch(blk)
        self._blocks[blk.block_id] = blk
        self._index_add(blk)
        self.allocated_blocks += 1
        return blk

    def _lookup(self, parent_key: Any, seg: tuple) -> Optional[KVBlock]:
        """A live block holding exactly ``seg`` after prefix ``parent_key``."""
        if len(seg) == self.block_size:
            bid = self._full_index.get((parent_key, seg))
            return self._blocks.get(bid) if bid is not None else None
        for bid in self._partial_index.get(parent_key, ()):
            blk = self._blocks.get(bid)
            if blk is not None and tuple(blk.tokens) == seg:
                return blk
        return None

    def _chain_key_of(self, table: BlockTable) -> Any:
        """Chain key after the table's trailing full blocks (for appends)."""
        if not table.block_ids:
            return _ROOT
        last = self._blocks[table.block_ids[-1]]
        return last.key if last.full else last.parent_key

    # ----------------------------------------------------------------- alloc

    def allocate(self, seq_id: int, tokens: Sequence[int]) -> BlockTable:
        """Build a block table for ``tokens``, sharing every content-matched
        block (refcount++) and allocating the rest; atomic — on PageError the
        partial allocation is rolled back and the pool is unchanged."""
        if seq_id in self._tables:
            raise PageError(f"sequence {seq_id} already allocated")
        self._resident.pop(seq_id, None)
        table = BlockTable(seq_id)
        shared: list[KVBlock] = []
        created: list[KVBlock] = []
        parent = _ROOT
        try:
            i = 0
            while i < len(tokens):
                seg = tuple(int(t) for t in tokens[i : i + self.block_size])
                blk = self._lookup(parent, seg)
                if blk is not None:
                    blk.refcount += 1
                    self._touch(blk)
                    shared.append(blk)
                    self.shared_hits += 1
                else:
                    blk = self._new_block(seg, parent)
                    created.append(blk)
                table.block_ids.append(blk.block_id)
                table.n_tokens += len(seg)
                if len(seg) == self.block_size:
                    parent = (parent, seg)
                i += len(seg)
        except PageError:
            for b in shared:
                b.refcount -= 1
            for b in created:
                self._drop_block(b)
            raise
        self._tables[seq_id] = table
        return table

    def append_token(self, seq_id: int, token: int) -> dict:
        """Record one more fed token for ``seq_id``.  May allocate a fresh
        block (last one full) or copy-on-write a shared partial block.
        Returns an event dict: ``{"new_block": bool, "cow": (old, new)|None}``.
        """
        table = self._tables[seq_id]
        token = int(token)
        ev = {"new_block": False, "cow": None}
        last = self._blocks[table.block_ids[-1]] if table.block_ids else None
        if last is None or last.full:
            blk = self._new_block((token,), self._chain_key_of(table))
            table.block_ids.append(blk.block_id)
            ev["new_block"] = True
        else:
            if last.refcount > 1:
                # divergent write into a shared partial block: copy-on-write
                copy = self._new_block(tuple(last.tokens), last.parent_key)
                copy.payload = last.payload  # snapshot; replaced at writeback
                last.refcount -= 1
                table.block_ids[-1] = copy.block_id
                self.cow_copies += 1
                ev["cow"] = (last.block_id, copy.block_id)
                last = copy
            self._index_remove(last)
            last.tokens.append(token)
            self._touch(last)
            self._index_add(last)
        table.n_tokens += 1
        return ev

    # ---------------------------------------------------------------- staging
    #
    # Uncommitted payload rows for speculative decoding: a verify step parks
    # the KV rows of *drafted* positions here; the commit path promotes the
    # accepted prefix into block payloads and the rest is dropped.  Rows are
    # opaque to the pool (same contract as ``KVBlock.payload``); at most one
    # staged range per sequence — re-staging overwrites (a rolled-back verify
    # re-runs and restages idempotently).

    def stage_rows(self, seq_id: int, start: int, rows: Any) -> None:
        """Park uncommitted KV rows for positions ``[start, start+len)``."""
        if seq_id not in self._tables:
            raise PageError(f"sequence {seq_id} not active; cannot stage rows")
        self._staged[seq_id] = (int(start), rows)
        self.staged_rounds += 1

    def staged(self, seq_id: int) -> Optional[tuple]:
        """Peek the staged ``(start, rows)`` for a sequence, if any."""
        return self._staged.get(seq_id)

    def take_staged(self, seq_id: int) -> Optional[tuple]:
        """Pop and return the staged ``(start, rows)`` (commit path)."""
        return self._staged.pop(seq_id, None)

    def drop_staged(self, seq_id: int) -> None:
        """Discard uncommitted rows (rollback / cancel / preemption)."""
        if self._staged.pop(seq_id, None) is not None:
            self.staged_drops += 1

    # --------------------------------------------------------------- release

    def release(self, seq_id: int, *, keep_resident: bool = True) -> None:
        """Drop the sequence's references.  ``keep_resident=True`` keeps the
        table resumable and the blocks cached (evictable once unreferenced);
        ``False`` frees unreferenced blocks immediately."""
        self.drop_staged(seq_id)  # uncommitted rows never outlive the slot
        table = self._tables.pop(seq_id, None)
        if table is None:
            self._resident.pop(seq_id, None)
            return
        for bid in table.block_ids:
            blk = self._blocks.get(bid)
            if blk is not None:
                blk.refcount -= 1
                self._touch(blk)
        if keep_resident:
            self._resident[seq_id] = table
        else:
            for bid in table.block_ids:
                blk = self._blocks.get(bid)
                if blk is not None and blk.refcount == 0:
                    self._drop_block(blk)

    def resume(self, seq_id: int) -> Optional[BlockTable]:
        """Re-pin a released sequence's blocks.  Returns its table if every
        block survived eviction, else None (caller must re-prefill)."""
        table = self._resident.pop(seq_id, None)
        if table is None:
            return None
        if not all(bid in self._blocks for bid in table.block_ids):
            return None
        for bid in table.block_ids:
            blk = self._blocks[bid]
            blk.refcount += 1
            self._touch(blk)
        self._tables[seq_id] = table
        return table

    # ---------------------------------------------------------------- lookup

    def probe_restore(self, tokens: Sequence[int]) -> bool:
        """True when every block that :meth:`allocate` would share for
        ``tokens`` is live *and payload-backed* — i.e. the engine can restore
        the KV rows instead of recomputing prefill."""
        if not len(tokens):
            return False
        parent = _ROOT
        i = 0
        while i < len(tokens):
            seg = tuple(int(t) for t in tokens[i : i + self.block_size])
            blk = self._lookup(parent, seg)
            if blk is None or blk.payload is None:
                return False
            if len(seg) == self.block_size:
                parent = (parent, seg)
            i += len(seg)
        return True

    def block(self, block_id: int) -> KVBlock:
        return self._blocks[block_id]

    def refcount(self, block_id: int) -> int:
        return self._blocks[block_id].refcount

    def table_of(self, seq_id: int) -> Optional[BlockTable]:
        return self._tables.get(seq_id)

    def blocks_of(self, seq_id: int) -> list[KVBlock]:
        table = self._tables.get(seq_id) or self._resident.get(seq_id)
        if table is None:
            return []
        return [self._blocks[b] for b in table.block_ids if b in self._blocks]

    def resident(self, seq_id: int) -> bool:
        table = self._resident.get(seq_id)
        return table is not None and all(b in self._blocks for b in table.block_ids)

    # ----------------------------------------------------------------- stats

    @property
    def n_live(self) -> int:
        return len(self._blocks)

    @property
    def n_free(self) -> int:
        return self.n_blocks - len(self._blocks)

    @property
    def n_evictable(self) -> int:
        return sum(1 for b in self._blocks.values() if b.refcount == 0)

    @property
    def occupancy(self) -> float:
        return len(self._blocks) / self.n_blocks

    def stats(self) -> dict:
        return {
            "n_blocks": self.n_blocks,
            "block_size": self.block_size,
            "live_blocks": self.n_live,
            "evictable_blocks": self.n_evictable,
            "occupancy": self.occupancy,
            "allocated_blocks": self.allocated_blocks,
            "shared_hits": self.shared_hits,
            "cow_copies": self.cow_copies,
            "evictions": self.evictions,
            "staged_rounds": self.staged_rounds,
            "staged_drops": self.staged_drops,
        }
