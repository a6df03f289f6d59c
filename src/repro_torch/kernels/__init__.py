"""Hand-written Hopper kernels for the compute hot spots of the serving paths.

Each forward kernel replaces one Pallas TPU kernel of ``repro.kernels``; the
two backward kernels (training) have no Pallas counterpart, JAX
differentiating the jnp code they mirror:

* ``rmsnorm``          — fused RMS-normalise + scale, and its backward
  (``csrc/rmsnorm.cu``);
* ``flash_attention``  — causal / windowed GQA prefill and train attention
  (``csrc/flash_attention.cu``), and its backward
  (``csrc/flash_attention_bwd.cu``);
* ``decode_attention`` — one-token attention against the KV cache with a
  per-sequence position (``csrc/decode_attention.cu``);
* ``ssd``              — the Mamba-2 SSD intra-chunk step, and the chunked
  scan around it (``csrc/ssd.cu``).

Every kernel directory holds ``ops.py`` (the wrapper: checks, launch, launch
counter, and the kernel's Specx codelet with ``ref`` and ``cuda``
implementations) and ``ref.py`` (the plain PyTorch version, used for CPU
tensors).
``dispatch.py`` probes the card and builds the shared library.
"""
