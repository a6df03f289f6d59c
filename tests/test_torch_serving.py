"""The port's continuous-batching ServeEngine against ``repro``'s.

With the same (bridged) float32 weights, greedy token streams must be
identical for the serving scenarios of ``tests/test_serving.py``: staggered
prompts, a shared prefix with copy-on-write, restore instead of prefill, and
a preemption round trip.  Sampling draws from ``torch`` generators, which
cannot replay ``jax.random``, so it is tested inside the port: the same seed
gives the same tokens, top-1 equals greedy, and a re-decoded position (after
preemption) redraws the same token.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import decode_step, prefill  # noqa: E402
from repro_torch.runtime.serve import prime_cache  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402

pytestmark = pytest.mark.timeout(180)


@pytest.fixture(scope="module")
def served():
    """``tests/test_serving.py``'s fixture, carried into the port."""
    jcfg = jax_reduced_config("deepseek-7b").replace(dtype="float32")
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = reduced_config("deepseek-7b").replace(dtype="float32")
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, model


def _engines(served, **kw):
    jcfg, jparams, cfg, model = served
    return JaxServeEngine(jcfg, jparams, **kw), ServeEngine(cfg, model, device="cpu", **kw)


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def test_staggered_prompts_match_repro(served):
    prompts = _prompts(0, (5, 9, 7), served[2].vocab)
    streams = []
    for eng in _engines(served, n_slots=4, max_seq=32, block_size=4):
        with eng:
            reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
            eng.run_until_drained(max_iters=50)
            assert all(r.done for r in reqs)
            streams.append([r.out_tokens for r in reqs])
    assert streams[1] == streams[0]


def test_shared_prefix_cow_matches_repro(served):
    (p,) = _prompts(4, (9,), served[2].vocab)
    streams = []
    for eng in _engines(served, n_slots=4, max_seq=32, block_size=4):
        with eng:
            a, b = eng.submit(p, 4), eng.submit(p, 4)
            eng.step()  # admission only: both prefilled + installed
            ta, tb = eng.pool.table_of(a.req_id), eng.pool.table_of(b.req_id)
            assert [eng.pool.refcount(i) for i in ta.block_ids] == [2, 2, 2]
            eng.step()  # the first appended token copy-on-writes the shared tail
            assert eng.pool.cow_copies == 1 and ta.block_ids[-1] != tb.block_ids[-1]
            eng.run_until_drained()
            assert a.out_tokens == b.out_tokens
            streams.append(a.out_tokens)
    assert streams[1] == streams[0]


def test_restore_skips_prefill_matches_repro(served):
    (p,) = _prompts(5, (9,), served[2].vocab)
    streams = []
    for eng in _engines(served, n_slots=2, max_seq=32, block_size=4):
        with eng:
            r1 = eng.submit(p, 5)
            eng.run_until_drained()
            prefills = eng.prefills
            r2 = eng.submit(p, 5)
            eng.run_until_drained()
            assert eng.prefills == prefills and eng.restores == 1
            assert r2.out_tokens == r1.out_tokens
            streams.append(r1.out_tokens)
    assert streams[1] == streams[0]


def test_preemption_roundtrip_matches_repro(served):
    p1, p2 = _prompts(7, (5, 5), served[2].vocab)
    streams = []
    for eng in _engines(served, n_slots=2, max_seq=16, block_size=4, n_blocks=4):
        with eng:
            r1, r2 = eng.submit(p1, 8), eng.submit(p2, 8)
            eng.run_until_drained(max_iters=200)
            assert r1.done and r2.done
            assert eng.scheduler.preemptions >= 1
            streams.append((r1.out_tokens, r2.out_tokens))
    assert streams[1] == streams[0]


def test_gemma_head256_streams_match_repro():
    """gemma-7b's layout at its head dim of 256 (two heads): staggered
    greedy prompts give the same streams in both packages."""
    over = dict(dtype="float32", head_dim=256, n_heads=2, n_kv_heads=2)
    jcfg = jax_reduced_config("gemma-7b").replace(**over)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = reduced_config("gemma-7b").replace(**over)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    prompts = _prompts(2, (5, 11, 7), cfg.vocab)
    streams = []
    for eng in _engines((jcfg, jparams, cfg, model), n_slots=4, max_seq=32, block_size=4):
        with eng:
            reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
            eng.run_until_drained(max_iters=50)
            assert all(r.done for r in reqs)
            streams.append([r.out_tokens for r in reqs])
    assert streams[1] == streams[0]


def test_engine_matches_sequential_port_loop(served):
    """Inside the port: the engine's greedy stream equals prefill + a
    decode_step loop (``tests/test_serving.py``'s oracle)."""
    _, _, cfg, model = served
    prompts = _prompts(0, (5, 9), cfg.vocab)
    with ServeEngine(cfg, model, n_slots=2, max_seq=32, block_size=4, device="cpu") as eng:
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_until_drained()
    for p, r in zip(prompts, reqs):
        logits, caches = prefill(model, {"tokens": torch.from_numpy(p[None, :])}, cfg)
        caches = prime_cache(cfg, caches, len(p), 32)
        toks = [int(torch.argmax(logits[0, -1]))]
        for s in range(5):
            t = torch.tensor([[toks[-1]]], dtype=torch.int32)
            logits, caches = decode_step(model, t, caches, len(p) + s, cfg)
            toks.append(int(torch.argmax(logits[0, 0])))
        assert r.out_tokens == toks


def _run_sampled(served, temp, top_k, seed, **kw):
    _, _, cfg, model = served
    prompts = _prompts(9, (7, 6), cfg.vocab)
    with ServeEngine(cfg, model, device="cpu", **kw) as eng:
        reqs = [eng.submit(p, 8, temperature=temp, top_k=top_k, seed=seed + i)
                for i, p in enumerate(prompts)]
        eng.run_until_drained(max_iters=200)
        return [r.out_tokens for r in reqs], eng.scheduler.preemptions


def test_sampling_deterministic_and_position_keyed(served):
    kw = dict(n_slots=2, max_seq=32, block_size=4)
    a, _ = _run_sampled(served, 0.8, 5, 42, **kw)
    b, _ = _run_sampled(served, 0.8, 5, 42, **kw)
    assert a == b  # same seed → same tokens
    c, _ = _run_sampled(served, 0.8, 5, 43, **kw)
    assert c != a  # the seed matters
    # top-1 sampling is greedy
    assert _run_sampled(served, 1.0, 1, 3, **kw)[0] == _run_sampled(served, 0.0, 0, 0, **kw)[0]
    # under pool pressure sequences are preempted and re-decoded: the draw is
    # keyed by (seed, absolute position), so the text does not change
    d, preempted = _run_sampled(served, 0.8, 5, 42, n_slots=2, max_seq=16, block_size=4, n_blocks=5)
    assert preempted >= 1 and d == a


def test_engine_refuses_draft_model_and_wrong_device(served):
    # the draft model is served now (tests/test_torch_spec.py): only the
    # wrong-device half is left here
    _, _, cfg, model = served
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ServeEngine(cfg, model)  # device defaults to cuda


def test_launch_serve_cpu_returns_dict():
    from repro_torch.launch.serve import main

    out = main(["--arch", "deepseek-7b", "--reduced", "--device", "cpu",
                "--requests", "3", "--slots", "2", "--gen", "4"])
    assert out["stats"]["prefills"] == 3 and out["tok_per_s"] > 0
    assert out["reject_reasons"] == {}


@pytest.mark.parametrize("arch", ["minicpm3-4b", "recurrentgemma-9b", "qwen3-moe-235b-a22b"])
def test_launch_serve_other_families_cpu_returns_dict(arch):
    """MLA (pageable latent rows), the RG-LRU hybrid (not pageable) and MoE
    through the serve launcher on the CPU."""
    from repro_torch.launch.serve import main

    out = main(["--arch", arch, "--reduced", "--device", "cpu",
                "--requests", "3", "--slots", "2", "--gen", "4"])
    assert out["stats"]["prefills"] == 3 and out["tok_per_s"] > 0
    assert out["stats"]["pageable"] == (arch != "recurrentgemma-9b")
