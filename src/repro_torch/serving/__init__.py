"""Serving tier: paged KV cache, admission control, continuous batching.

``kvcache``    — :class:`KVPagePool`: fixed-size blocks, prefix sharing with
                 refcounts + copy-on-write, deterministic LRU eviction.
``scheduler``  — :class:`ServeScheduler`: bounded admission queue with
                 reject / shed-oldest overload policies, slot+block-aware
                 admission planning, preemption victims.
``engine``     — :class:`ServeEngine`: continuously-batched decoding on one
                 persistent SpTaskGraph; per-request sampling controls.
``spec``       — :class:`SpecDecoder`: draft-model speculative decoding as
                 SP_MODEL_2 uncertain-writer chains on the engine's
                 batch-state cell (commit/rollback via the runtime's
                 speculation machinery).
``loadgen``    — seeded Poisson load generator + latency metrics.
"""
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.kvcache import BlockTable, KVBlock, KVPagePool, PageError
from repro_torch.serving.loadgen import LoadSpec, build_workload, run_load
from repro_torch.serving.scheduler import Admission, AdmissionError, ServeScheduler
from repro_torch.serving.spec import SpecDecoder, shrunken_draft

__all__ = [
    "Admission",
    "AdmissionError",
    "BlockTable",
    "KVBlock",
    "KVPagePool",
    "LoadSpec",
    "PageError",
    "Request",
    "ServeEngine",
    "ServeScheduler",
    "SpecDecoder",
    "build_workload",
    "run_load",
    "shrunken_draft",
]
