"""The examples and the paper's two runtime demos, ported from ``examples/``.

Each runs on the card unless given ``--device cpu`` and has a ``main(argv)``
that returns what its output shows::

    python -m repro_torch.examples.quickstart
    python -m repro_torch.examples.heterogeneous_gemm      # paper §4.3, Fig. 2
    python -m repro_torch.examples.speculative_monte_carlo # paper §3.2
    python -m repro_torch.examples.train_lm
    python -m repro_torch.examples.serve_lm --draft 4
"""
