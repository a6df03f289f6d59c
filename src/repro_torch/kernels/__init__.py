"""Hand-written Hopper kernels for the compute hot spots of the serving path.

Each kernel replaces one Pallas TPU kernel of ``repro.kernels``:

* ``rmsnorm``          — fused RMS-normalise + scale (``csrc/rmsnorm.cu``);
* ``flash_attention``  — causal / windowed GQA prefill attention
  (``csrc/flash_attention.cu``);
* ``decode_attention`` — one-token attention against the KV cache with a
  per-sequence position (``csrc/decode_attention.cu``).

Every kernel directory holds ``ops.py`` (the wrapper: checks, launch, launch
counter) and ``ref.py`` (the plain PyTorch version, used for CPU tensors).
``dispatch.py`` probes the card and builds the shared library.
"""
