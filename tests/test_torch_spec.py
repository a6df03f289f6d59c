"""The port's speculative decoding against ``repro``'s.

With the same (bridged) float32 weights on the reduced deepseek-7b, greedy
speculative streams must equal ``repro``'s ``ServeEngine(draft_cfg=...)``
streams token for token and the port's own plain engine, for the scenarios
of ``tests/test_spec_decode.py``: self draft in a mixed batch, a garbage
draft, the shrunken draft, mid-flight join and leave, forced rollback,
preemption and shed under pool pressure, streaming, staged rows promoted,
and the load generator's checksum.  Sampling draws from ``torch``
generators, which cannot replay ``jax.random``, so sampled speculation is
held against the port's plain engine.
"""
from __future__ import annotations

import dataclasses
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models.transformer import verify_step as jax_verify_step  # noqa: E402
from repro.runtime.serve import prime_cache as jax_prime_cache  # noqa: E402
from repro.serving import LoadSpec as JaxLoadSpec  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serving import build_workload as jax_build_workload  # noqa: E402
from repro.serving import run_load as jax_run_load  # noqa: E402
from repro.serving import shrunken_draft as jax_shrunken_draft  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import decode_step, init_params, prefill, verify_step  # noqa: E402
from repro_torch.runtime.serve import build_verify_fn, prime_cache  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    LoadSpec,
    ServeEngine,
    build_workload,
    run_load,
    shrunken_draft,
)
from repro_torch.serving.loadgen import warm_up  # noqa: E402

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(scope="module")
def served():
    """``tests/test_spec_decode.py``'s fixtures (target and garbage draft),
    carried into the port."""
    jcfg = jax_reduced_config("deepseek-7b").replace(dtype="float32")
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    jgarbage = jax_init_params(jax.random.PRNGKey(99), jcfg)
    cfg = reduced_config("deepseek-7b").replace(dtype="float32")
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    garbage = params_from_numpy(jax.tree.map(np.asarray, jgarbage), cfg, device="cpu")
    return dict(jcfg=jcfg, jparams=jparams, jgarbage=jgarbage, cfg=cfg, model=model,
                garbage=garbage)


def _prompts(cfg, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=L).astype(np.int32) for L in lens]


def _drafts(sv, kind):
    """(repro draft (cfg, params), port draft (cfg, model)) of ``kind``."""
    if kind == "self":
        return (sv["jcfg"], sv["jparams"]), (sv["cfg"], sv["model"])
    if kind == "garbage":
        return (sv["jcfg"], sv["jgarbage"]), (sv["cfg"], sv["garbage"])
    return (jax_shrunken_draft(sv["jcfg"], sv["jparams"], n_layers=1),
            shrunken_draft(sv["cfg"], sv["model"], n_layers=1))


def _run(eng, script):
    """Drive ``eng`` by ``script(eng)`` → its requests; → (streams, stats)."""
    with eng:
        reqs = script(eng)
        eng.run_until_drained()
        assert all(r.done for r in reqs)
        return [r.out_tokens for r in reqs], eng.stats()


def _three_ways(sv, kind, script, draft_k=3, **kw):
    """Run ``script`` on repro's spec engine, the port's spec engine and the
    port's plain engine; → (repro, port, plain) (streams, stats) pairs."""
    (jdc, jdp), (dc, dp) = _drafts(sv, kind)
    jax_out = _run(JaxServeEngine(sv["jcfg"], sv["jparams"], draft_cfg=jdc, draft_params=jdp,
                                  draft_k=draft_k, **kw), script)
    port = _run(ServeEngine(sv["cfg"], sv["model"], device="cpu", draft_cfg=dc, draft_params=dp,
                            draft_k=draft_k, **kw), script)
    plain = _run(ServeEngine(sv["cfg"], sv["model"], device="cpu", **kw),
                 lambda eng: script(eng, plain=True))
    return jax_out, port, plain


# ---------------------------------------------------------------------------
# verify_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("advance", [None, (1, 0, 1)])
def test_verify_step_is_decode_step_unrolled(served, advance):
    """Bit for bit T calls of ``decode_step`` at ``pos + j·advance``, and
    within fp32 1e-5 of ``repro``'s ``verify_step`` from bridged weights.
    Without ``advance`` every slot advances, from a scalar ``pos``."""
    cfg, model = served["cfg"], served["model"]
    B, T, max_seq = 3, 4, 24
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, size=(B, 7)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)
    pos = np.array([7, 7, 7], np.int32)
    adv = np.ones(B, np.int32) if advance is None else np.asarray(advance, np.int32)

    _, caches = prefill(model, {"tokens": torch.from_numpy(prompt)}, cfg)
    caches = prime_cache(cfg, caches, 7, max_seq)
    loop = {k: v.clone() for k, v in caches.items()}
    if advance is None:
        got, caches = verify_step(model, torch.from_numpy(toks), caches, 7, cfg)
    else:
        got, caches = build_verify_fn(cfg)(model, torch.from_numpy(toks), caches,
                                           torch.from_numpy(pos), torch.from_numpy(adv))
    want = []
    for j in range(T):
        lg, loop = decode_step(model, torch.from_numpy(toks[:, j:j + 1]), loop,
                               torch.from_numpy(pos + j * adv), cfg)
        want.append(lg)
    assert torch.equal(got, torch.cat(want, dim=1))
    assert all(torch.equal(caches[k], loop[k]) for k in caches)

    jcfg, jparams = served["jcfg"], served["jparams"]
    _, jc = jax_prefill(jparams, {"tokens": jnp.asarray(prompt)}, jcfg)
    jc = jax_prime_cache(jcfg, jc, 7, max_seq)
    jlogits, _ = jax_verify_step(jparams, jnp.asarray(toks), jc, jnp.asarray(pos), jcfg,
                                 advance=None if advance is None else jnp.asarray(adv))
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# greedy streams: repro == port == port plain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["self", "garbage", "shrunken"])
def test_greedy_streams_match_repro_and_plain(served, kind):
    """Self draft in a mixed spec/plain batch (every proposal accepted), a
    draft with unrelated weights (mostly rejected, never rolled back), the
    1-layer shrunken draft: the committed streams are repro's and the
    plain engine's."""
    cfg = served["cfg"]
    lens = {"self": (6, 9, 5, 7), "garbage": (6, 9, 5), "shrunken": (6, 7)}[kind]
    seed = {"self": 3, "garbage": 7, "shrunken": 11}[kind]
    prompts = _prompts(cfg, lens, seed)
    n_new = 10 if kind == "self" else 8
    mixed = kind == "self"

    def script(eng, plain=False):
        return [eng.submit(p, n_new, **({} if plain else dict(speculative=(i % 2 == 0) or not mixed)))
                for i, p in enumerate(prompts)]

    (jax_streams, _), (streams, st), (plain, _) = _three_ways(
        served, kind, script, n_slots=3 if kind != "shrunken" else 2, max_seq=48, block_size=4)
    assert streams == jax_streams
    assert streams == plain
    sp = st["spec"]
    assert sp["graph"]["commits"] > 0 and sp["graph"]["rollbacks"] == 0
    if kind == "self":
        assert sp["accept_rate"] == 1.0
    if kind == "garbage":
        assert sp["accept_rate"] < 0.5


def test_spec_request_accounting_and_plain_riders(served):
    cfg, model = served["cfg"], served["model"]
    prompts = _prompts(cfg, (6, 9), 3)
    with ServeEngine(cfg, model, device="cpu", n_slots=2, max_seq=48, block_size=4,
                     draft_cfg=cfg, draft_params=model, draft_k=3) as eng:
        spec = eng.submit(prompts[0], 10, speculative=True)
        rider = eng.submit(prompts[1], 10, speculative=False)
        eng.run_until_drained()
    assert spec.spec_rounds > 0 and spec.spec_accepted > 0
    assert rider.spec_rounds == 0 and rider.spec_accepted == 0


def test_shrunken_draft_shares_the_target_modules(served):
    cfg, model = served["cfg"], served["model"]
    dcfg, draft = shrunken_draft(cfg, model, n_layers=1)
    assert dcfg.n_layers == 1 and len(draft.layers) == 1
    assert draft.layers[0] is model.layers[0]
    assert draft.embedding is model.embedding and draft.final_norm is model.final_norm
    assert getattr(draft, "unembed", None) is getattr(model, "unembed", None)
    n_target = {id(p) for p in model.parameters()}
    assert all(id(p) in n_target for p in draft.parameters())


def test_mid_flight_join_and_leave(served):
    cfg = served["cfg"]
    prompts = _prompts(cfg, (6, 9, 5), seed=13)

    def script(eng, plain=False):
        spec = (lambda s: {}) if plain else (lambda s: dict(speculative=s))
        a = eng.submit(prompts[0], 14, **spec(True))
        b = eng.submit(prompts[1], 3, **spec(False))  # leaves early
        for _ in range(2):
            eng.step(wait=True)
        c = eng.submit(prompts[2], 9, **spec(True))  # joins mid-flight
        return [a, b, c]

    (jax_streams, _), (streams, _), (plain, _) = _three_ways(
        served, "self", script, n_slots=3, max_seq=64, block_size=4)
    assert streams == jax_streams == plain


def test_forced_rollback_recovers_bit_exact(served):
    """A poisoned round re-runs verify on the real state (SP_MODEL_2
    rollback): its T = 1 pass rewrites row P with the pending token, which
    the aliased cache tolerates; the streams stay exact."""
    cfg = served["cfg"]
    prompts = _prompts(cfg, (6, 9), seed=17)

    def script(eng, plain=False):
        reqs = [eng.submit(p, 10) for p in prompts]
        eng.step(wait=True)
        if not plain:
            eng.force_rollback(2)
        return reqs

    (jax_streams, jst), (streams, st), (plain, _) = _three_ways(
        served, "self", script, n_slots=2, max_seq=48, block_size=4)
    assert streams == jax_streams == plain
    sp = st["spec"]
    assert sp["rollback_rounds"] == 2 == jst["spec"]["rollback_rounds"]
    assert sp["graph"]["rollbacks"] == 2 and sp["graph"]["commits"] > 0


def test_preemption_and_shed_under_pool_pressure(served):
    cfg = served["cfg"]
    prompts = _prompts(cfg, (6, 9, 5, 7, 8, 6), seed=19)

    def script(eng, plain=False):
        return [eng.submit(p, 12, **({} if plain else dict(speculative=(i % 2 == 0))))
                for i, p in enumerate(prompts)]

    (jax_streams, _), (streams, st), (plain, _) = _three_ways(
        served, "self", script, draft_k=4, n_slots=4, max_seq=64, block_size=4, n_blocks=12)
    assert st["preemptions"] > 0 and st["spec"]["sheds"] > 0
    assert streams == jax_streams == plain


def test_near_the_last_cache_row_the_slot_rides_along(served):
    """prompt + max_new_tokens == max_seq: the last rounds' k drafted rows
    would pass the cache's end (repro drops those writes, a CUDA index
    would assert), so the slot decodes plainly; the stream is unchanged."""
    cfg = served["cfg"]
    prompts = _prompts(cfg, (16, 17), seed=53)

    def script(eng, plain=False):
        return [eng.submit(p, 24 - len(p)) for p in prompts]

    (jax_streams, _), (streams, st), (plain, _) = _three_ways(
        served, "self", script, draft_k=4, n_slots=2, max_seq=24, block_size=4)
    assert streams == jax_streams == plain
    assert [len(s) for s in streams] == [8, 7]
    # the self draft is always right: only the ride-along rounds reject
    assert st["spec"]["accepted"] < st["spec"]["proposed"]


# ---------------------------------------------------------------------------
# sampling, streaming, staging: inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("top_k", [0, 5])
def test_sampled_spec_matches_plain(served, top_k):
    """The uniform of the token at absolute index i is position_uniform(seed,
    i) on both paths, so sampled speculation equals sampled plain decode."""
    cfg, model = served["cfg"], served["model"]
    prompts = _prompts(cfg, (6, 9, 5), seed=23)
    kw = dict(temperature=0.8, top_k=top_k)
    outs = []
    for draft in (dict(draft_cfg=cfg, draft_params=model, draft_k=3), {}):
        with ServeEngine(cfg, model, device="cpu", n_slots=3, max_seq=48, block_size=4, **draft) as eng:
            reqs = [eng.submit(p, 8, seed=5 + i, **kw) for i, p in enumerate(prompts)]
            eng.run_until_drained()
            outs.append([r.out_tokens for r in reqs])
            if draft:
                assert eng.stats()["spec"]["rounds"] > 0
    assert outs[0] == outs[1]


@pytest.mark.parametrize("how", ["on_token", "stream"])
def test_consumers_see_only_committed_tokens(served, how):
    cfg, model = served["cfg"], served["model"]
    [p] = _prompts(cfg, (6,), seed=31)
    got = []
    with ServeEngine(cfg, model, device="cpu", n_slots=2, max_seq=48, block_size=4,
                     draft_cfg=cfg, draft_params=model, draft_k=3) as eng:
        if how == "on_token":
            r = eng.submit(p, 10, speculative=True, on_token=got.append)
            eng.run_until_drained()
        else:
            r = eng.submit(p, 10, speculative=True)
            t = threading.Thread(target=lambda: got.extend(r.stream(timeout=120)))
            t.start()
            eng.run_until_drained()
            t.join(timeout=120)
            assert not t.is_alive()
    with ServeEngine(cfg, model, device="cpu", n_slots=2, max_seq=48, block_size=4) as eng:
        want = eng.submit(p, 10)
        eng.run_until_drained()
    assert got == r.out_tokens == want.out_tokens


def test_staged_rows_promoted_to_block_payloads(served):
    """Blocks filled by committed speculative tokens take their payloads
    from the staged verify rows (host copies), and a repeat of the prompt
    restores from them instead of prefilling."""
    cfg, model = served["cfg"], served["model"]
    [p] = _prompts(cfg, (5,), seed=47)
    with ServeEngine(cfg, model, device="cpu", n_slots=2, max_seq=48, block_size=4,
                     draft_cfg=cfg, draft_params=model, draft_k=3) as eng:
        r = eng.submit(p, 11, speculative=True)
        live = {k: c.untyped_storage().data_ptr() for k, c in eng._caches.items()}
        promoted = 0
        while not r.done:
            eng.step()
            table = eng.pool.table_of(r.req_id)
            for bid in table.block_ids if table is not None else ():
                payload = eng.pool.block(bid).payload
                for k, t in (payload or {}).items():  # never a view of the live cache
                    assert t.device.type == "cpu" and t.untyped_storage().data_ptr() != live[k]
                promoted += payload is not None
        assert promoted > 0
        assert eng.stats()["spec"]["staged_promotions"] > 0
        prefills_before = eng.stats()["prefills"]
        r2 = eng.submit(p, 6, speculative=True)
        eng.run_until_drained()
        assert r2.out_tokens == r.out_tokens[:6]
        assert eng.stats()["restores"] >= 1
        assert eng.stats()["prefills"] == prefills_before


# ---------------------------------------------------------------------------
# configuration errors
# ---------------------------------------------------------------------------

def test_shrunken_draft_rejects_non_pageable():
    cfg = reduced_config("mamba2-130m")
    with pytest.raises(ValueError, match="per-token KV rows"):
        shrunken_draft(cfg, None, n_layers=1)
    model = init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="pageable target"):
        ServeEngine(cfg, model, device="cpu", n_slots=1, max_seq=32, draft_cfg=cfg,
                    draft_params=model)


@pytest.mark.parametrize("case", ["vocab", "submit", "force_rollback", "depth"])
def test_configuration_errors(served, case):
    cfg, model = served["cfg"], served["model"]
    kw = dict(device="cpu", n_slots=1, max_seq=32, block_size=4)
    if case == "vocab":
        bad = cfg.replace(vocab=cfg.vocab // 2)
        with pytest.raises(ValueError, match="vocab"):
            ServeEngine(cfg, model, draft_cfg=bad, draft_params=init_params(bad, 0, device="cpu"),
                        draft_k=2, **kw)
    elif case == "depth":
        with pytest.raises(ValueError, match="k must be"):
            ServeEngine(cfg, model, draft_cfg=cfg, draft_params=model, draft_k=0, **kw)
    else:
        with ServeEngine(cfg, model, **kw) as eng:
            if case == "submit":
                with pytest.raises(ValueError, match="draft model"):
                    eng.submit(np.arange(4, dtype=np.int32), 4, speculative=True)
            else:
                with pytest.raises(RuntimeError, match="no draft model"):
                    eng.force_rollback()


# ---------------------------------------------------------------------------
# the load generator
# ---------------------------------------------------------------------------

def test_build_workload_matches_repro():
    kw = dict(seed=3, n_requests=12, rate_rps=50.0, prompt_lens=(5, 9, 13), out_lens=(4, 8),
              vocab=40, dup_frac=0.25)
    mine, theirs = build_workload(LoadSpec(**kw)), jax_build_workload(JaxLoadSpec(**kw))
    assert [(a.at, a.max_new_tokens, a.prompt.tolist()) for a in mine] == \
        [(a.at, a.max_new_tokens, a.prompt.tolist()) for a in theirs]


def test_run_load_speculative_checksum_matches_plain_and_repro(served):
    cfg, model = served["cfg"], served["model"]
    spec = LoadSpec(seed=3, n_requests=4, rate_rps=500.0, prompt_lens=(5, 9), out_lens=(6,),
                    vocab=32, dup_frac=0.0, speculative=True)
    wl = build_workload(spec)
    kw = dict(n_slots=3, max_seq=48, block_size=4)
    with ServeEngine(cfg, model, device="cpu", draft_cfg=cfg, draft_params=model, draft_k=3,
                     **kw) as eng:
        res_spec = run_load(eng, wl, mode="continuous", spec=spec)
    plain_spec = dataclasses.replace(spec, speculative=False)
    with ServeEngine(cfg, model, device="cpu", **kw) as eng:
        res_plain = run_load(eng, wl, mode="continuous", spec=plain_spec)
    with ServeEngine(cfg, model, device="cpu", **kw) as eng:
        res_drain = run_load(eng, wl, mode="drain", spec=plain_spec)
    jspec = JaxLoadSpec(**dataclasses.asdict(plain_spec))
    with JaxServeEngine(served["jcfg"], served["jparams"], **kw) as eng:
        res_jax = jax_run_load(eng, jax_build_workload(jspec), mode="continuous", spec=jspec)
    assert res_spec["output_checksum"] == res_plain["output_checksum"]
    assert res_drain["output_checksum"] == res_plain["output_checksum"]
    assert res_jax["output_checksum"] == res_plain["output_checksum"]
    assert res_spec["engine"]["spec"]["graph"]["commits"] > 0
    assert res_spec["requests"] == 4 and res_spec["rejected"] == 0
    # tokens committed in one round share a timestamp: ITL p50 may be 0
    for key in ("ttft_p50_ms", "ttft_p99_ms", "itl_p99_ms", "tokens_per_s"):
        assert res_spec[key] > 0


def test_warm_up_refuses_a_token_past_the_vocabulary(served):
    cfg, model = served["cfg"], served["model"]
    with ServeEngine(cfg, model, device="cpu", n_slots=1, max_seq=32, block_size=4) as eng:
        with pytest.raises(ValueError, match="vocabulary"):
            warm_up(eng, LoadSpec(vocab=cfg.vocab - 1, prompt_lens=(5,)))
        assert eng.stats()["prefills"] == 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launch_serve_speculative_cpu():
    from repro_torch.launch.serve import main

    out = main(["--arch", "deepseek-7b", "--reduced", "--device", "cpu", "--requests", "3",
                "--slots", "2", "--gen", "6", "--draft-k", "4"])
    sp = out["stats"]["spec"]
    assert sp["draft_k"] == 4 and sp["rounds"] > 0 and sp["graph"]["rollbacks"] == 0
    assert out["tok_per_s"] > 0
