"""Deterministic synthetic data pipeline (a numpy copy of
``repro.data.pipeline``: the same arrays for the same ``(seed, step)``).

Restart-safety is the point: ``batch_for_step(step)`` is a pure function of
``(seed, step)``, so resuming from a checkpoint at step k replays the exact
stream — no data-state checkpointing needed (the data "cursor" *is* the
step counter).  In a multi-host deployment each host computes only its batch
slice (``host_index / host_count``); on this container that collapses to the
full batch.

A background :class:`Prefetcher` thread keeps ``depth`` batches ahead —
the host-side analogue of Specx's communication thread overlapping the
workers: data production is a task off the critical path.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.models.config import ArchConfig, ShapeSpec


def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """numpy dtypes/shapes of one global batch (mirrors models.input_defs)."""
    B, L = shape.global_batch, shape.seq_len
    if cfg.frontend == "audio":
        return {
            "embeds": ((B, L, 512), np.float32),
            "mask": ((B, L), np.bool_),
            "labels": ((B, L), np.int32),
        }
    if cfg.frontend == "vision":
        lt = L - cfg.n_patches
        return {
            "tokens": ((B, lt), np.int32),
            "patch_embeds": ((B, cfg.n_patches, 1024), np.float32),
            "labels": ((B, lt), np.int32),
        }
    return {"tokens": ((B, L), np.int32), "labels": ((B, L), np.int32)}


class SyntheticLMDataset:
    """Markov-ish synthetic token stream with learnable structure (so a ~100M
    model's loss visibly decreases within a few hundred steps)."""

    def __init__(
        self,
        cfg: ArchConfig,
        shape: ShapeSpec,
        seed: int = 0,
        host_index: int = 0,
        host_count: int = 1,
    ):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.host_index = host_index
        self.host_count = host_count
        assert shape.global_batch % host_count == 0
        self.local_batch = shape.global_batch // host_count

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_index])
        )

    def batch_for_step(self, step: int) -> dict:
        cfg, shape = self.cfg, self.shape
        rng = self._rng(step)
        B, L = self.local_batch, shape.seq_len
        if cfg.frontend == "audio":
            emb = rng.standard_normal((B, L, 512), dtype=np.float32)
            mask = rng.random((B, L)) < 0.08
            labels = rng.integers(0, cfg.vocab, (B, L), dtype=np.int32)
            return {"embeds": emb, "mask": mask, "labels": labels}
        lt = L - cfg.n_patches if cfg.frontend == "vision" else L
        # structured stream: x_{t+1} = (a·x_t + b) mod V.  The rule (a, b) is
        # fixed per dataset seed (a learnable "language"); only x0 varies per
        # step, so a ~100M model's loss drops fast.
        V = cfg.vocab
        rule = np.random.default_rng(np.random.SeedSequence([self.seed, 0xA11CE]))
        a = rule.integers(1, 8, (1, 1)).repeat(B, 0)
        b = rule.integers(0, V, (1, 1)).repeat(B, 0)
        x0 = rng.integers(0, V, (B, 1))
        toks = np.empty((B, lt + 1), dtype=np.int64)
        toks[:, :1] = x0
        for t in range(lt):
            toks[:, t + 1] = (a[:, 0] * toks[:, t] + b[:, 0]) % V
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if cfg.frontend == "vision":
            batch["patch_embeds"] = rng.standard_normal(
                (B, cfg.n_patches, 1024), dtype=np.float32
            )
        return batch

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_for_step(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of ``dataset.batch_for_step`` results."""

    def __init__(self, dataset: SyntheticLMDataset, start_step: int = 0, depth: int = 2):
        self.dataset = dataset
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._next = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        step = self._next
        while not self._stop.is_set():
            batch = self.dataset.batch_for_step(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self) -> tuple[int, dict]:
        return self._q.get()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
