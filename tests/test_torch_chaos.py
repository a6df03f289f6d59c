"""The port's chaos soak (``repro_torch.dist.chaos``) on the CPU: the three
chaos tests of ``tests/test_robustness.py`` with the same seeds and asserts
(torch payloads, ``device="cpu"``), the elastic scenario's seeded kill
against ``repro``'s, and a short soak over real sockets."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.dist import chaos  # noqa: E402


def test_chaos_collectives_bit_exact_under_link_faults():
    stats = chaos.chaos_collectives(seed=0, iters=6, device="cpu")
    assert stats["escalations"] == 0
    assert sum(stats["faults"].values()) > 0  # the schedule actually injected


def test_chaos_elastic_inprocess_rank_death():
    from repro.dist.chaos import chaos_elastic as jax_chaos_elastic

    stats = chaos.chaos_elastic(seed=0, iters=5, device="cpu")
    assert stats["resume"] is not None
    want = jax_chaos_elastic(seed=0, iters=5)
    assert (stats["kill_at"], stats["victim"]) == (want["kill_at"], want["victim"])


def test_chaos_serve_invariants():
    stats = chaos.chaos_serve(seed=0, iters=4, device="cpu")
    assert stats["completed"] > 0
    assert stats["requests"] == stats["completed"] + stats["deadline_shed"] \
        + stats["shed"] + stats["cancels"] + stats["cancelled_q"]


def test_chaos_collectives_p2p_short():
    """2 socket ranks, 2 iterations: bit-exact, no escalation, frames on
    the direct links (the function's own asserts); the ranks are joined
    within 60 s."""
    stats = chaos.chaos_collectives_p2p(seed=0, iters=2, size=2, timeout=30.0, join_timeout=60.0,
                                        device="cpu")
    assert stats["size"] == 2 and stats["escalations"] == 0


def test_chaos_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chaos.chaos_collectives(seed=0, iters=1)
    report = chaos.main(["--seeds", "1", "--iters", "1", "--scenario", "collectives", "--device", "cpu"])
    assert list(report) == ["collectives/seed0"]
