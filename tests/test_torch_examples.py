"""The port's examples (``repro_torch.examples``) on the CPU.

Each example's ``main(["--device", "cpu", ...])`` runs at a small size and
its result is checked; ``speculative_monte_carlo`` is held against
``examples/speculative_monte_carlo.py``'s ``run`` for the same seeds (both
are driven by numpy, so the values are equal).  On the card they run in
``chip_smoke.py``'s ``[examples]`` phase.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.examples import (  # noqa: E402
    heterogeneous_gemm,
    quickstart,
    serve_lm,
    speculative_monte_carlo,
    train_lm,
)
from repro_torch.kernels import dispatch  # noqa: E402

pytestmark = pytest.mark.timeout(300)
ROOT = Path(__file__).resolve().parents[1]


def _repro_example(name: str):
    spec = importlib.util.spec_from_file_location(f"repro_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_cpu(tmp_path):
    out = quickstart.main(["--device", "cpu", "--out-dir", str(tmp_path)])
    assert out["b"] == out["staged_b"] == [0.0, 2.0, 4.0, 6.0]
    assert out["acc"] == 28.0 and out["sum_cells"] == 9.0 and out["compat_d"] == 4.0
    assert out["double"] == 42.0 and out["double_ran"] == "ref"
    assert out["double_kinds"] == (["cuda", "ref"], ["ref"])
    assert out["spec_out"] == 100.0 and out["spec_stats"]["commits"] == 1
    assert all(Path(p).stat().st_size > 0 for p in out["exported"])


def test_heterogeneous_gemm_cpu(tmp_path):
    """The product equals A @ B within 1e-3; without a card every task runs
    the ``ref`` variant (the card worker falls back to it)."""
    out = heterogeneous_gemm.main(["--device", "cpu", "--n", "128", "--block", "32",
                                   "--out-dir", str(tmp_path)])
    assert out["tasks"] == 64 and out["by_kind"] == {"ref": 64}
    assert out["max_err"] < 1e-3
    assert all(Path(p).stat().st_size > 0 for p in out["exported"])


def test_speculative_monte_carlo_equals_repro():
    """Each (state, obs) equals ``repro``'s example's ``run`` for the same
    seed, with and without speculation."""
    jax_mc = _repro_example("speculative_monte_carlo")
    rows = speculative_monte_carlo.main(["--device", "cpu", "--steps", "12", "--seed", "3",
                                         "--accept-p", "0.0", "0.5"])
    for row in rows:
        _, s, o, _ = jax_mc.run(True, row["accept_p"], steps=12, seed=3)
        assert (row["state"], row["obs"]) == (s, o)
        assert row["commits"] + row["rollbacks"] == 12
    assert rows[0]["rollbacks"] == 0


def test_train_lm_loss_falls_on_cpu(tmp_path):
    out = train_lm.main(["--device", "cpu", "--steps", "12", "--seq", "32", "--batch", "4",
                         "--ckpt-dir", str(tmp_path), "--ckpt-every", "6"])
    assert len(out["losses"]) == 12 and all(np.isfinite(out["losses"]))
    assert out["last"] < out["first"] and out["saved"] == [6, 12]


def test_serve_lm_cpu_with_draft():
    """A fitted model continues the rule, the duplicate prompt shares its
    blocks and its stream, and the speculative run's streams equal the
    plain engine's."""
    out = serve_lm.main(["--device", "cpu", "--fit-steps", "30", "--batch", "4", "--gen", "8",
                         "--draft", "3"])
    assert out["accuracy"] > 0.5 and out["shared_hits"] > 0
    assert out["dup"] == out["out"][0] and out["spec_out"] == out["out"]


def test_examples_need_a_card_without_device_cpu():
    if dispatch.cuda_available():
        pytest.skip("a Hopper card is present: the default device runs")
    for mod in (quickstart, heterogeneous_gemm, speculative_monte_carlo, train_lm, serve_lm):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            mod.main([])


def test_speculative_monte_carlo_run_defaults_to_the_card():
    """The example's public ``run`` defaults to the card as the ``main``s
    do: without a Hopper card it raises, with one it runs there and gives
    the host's values."""
    if not dispatch.cuda_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            speculative_monte_carlo.run(True, 0.5, steps=2)
        return
    _, state, obs, _ = speculative_monte_carlo.run(True, 0.5, steps=6, seed=3)
    _, s_cpu, o_cpu, _ = speculative_monte_carlo.run(True, 0.5, steps=6, seed=3, device="cpu")
    assert (state, obs) == (s_cpu, o_cpu)
