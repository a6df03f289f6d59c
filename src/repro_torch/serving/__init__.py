"""Serving tier: paged KV cache, admission control, continuous batching.

``kvcache``    — :class:`KVPagePool`: fixed-size blocks, prefix sharing with
                 refcounts + copy-on-write, deterministic LRU eviction.
``scheduler``  — :class:`ServeScheduler`: bounded admission queue with
                 reject / shed-oldest overload policies, slot+block-aware
                 admission planning, preemption victims.
``engine``     — :class:`ServeEngine`: continuously-batched decoding on one
                 persistent SpTaskGraph; per-request sampling controls.
"""
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.kvcache import BlockTable, KVBlock, KVPagePool, PageError
from repro_torch.serving.scheduler import Admission, AdmissionError, ServeScheduler

__all__ = [
    "Admission",
    "AdmissionError",
    "BlockTable",
    "KVBlock",
    "KVPagePool",
    "PageError",
    "Request",
    "ServeEngine",
    "ServeScheduler",
]
