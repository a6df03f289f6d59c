"""PyTorch / CUDA port of the Specx reproduction, for NVIDIA Hopper (H100).

A package of its own beside ``repro`` (the JAX / Pallas reference): it imports
``torch``, numpy and the standard library only, never ``jax`` or ``repro``.
It mirrors ``repro``'s module names so each counterpart is easy to find:

* ``core``      — the Specx task runtime (own copy of ``repro.core``'s
                  graph, engine, schedulers, speculation, codelet frontend);
* ``configs``, ``models`` — architecture configs, the dense transformer and
                  the Mamba-2 stack as ``nn.Module``s with JAX's weight layouts;
* ``kernels``   — hand-written CUDA kernels for Hopper (rmsnorm, flash
                  attention, decode attention, ssd) beside their plain versions;
* ``runtime``, ``serving`` — cache priming and the continuous-batching
                  ``ServeEngine`` on one persistent task graph;
* ``launch``    — ``python -m repro_torch.launch.serve``;
* ``bridge``    — carries ``repro``'s numpy parameter tree into the port.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; asking for ``cuda`` without a Hopper card raises.
"""
