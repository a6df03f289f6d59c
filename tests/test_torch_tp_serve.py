"""Dense serving on the ``model`` mesh axis: ``prefill``, ``decode_step``,
``verify_step`` and ``build_serve_step`` tensor-parallel, with ``repro``'s
sequence-sharded KV cache (``kv_shard="seq"``) and its head-sharded one
(``"heads"``), against one process of the port and against ``repro``.

* the specs: ``runtime.serve.cache_shardings`` equals ``repro``'s for every
  ``"attn"`` config, both ``kv_shard`` values and both production meshes;
  ``init_cache`` / ``abstract_cache`` hold exactly the local shapes;
* the decode kernel's partial route (its plain version): m slices combined
  equal the whole cache, an empty slice included;
* one module-scoped 2-rank (1, 2) and one 4-rank (1, 4) gloo group, each
  serving reduced deepseek-7b (2 layers, float32) in five cases: dense,
  GQA (4 query heads on 2 KV heads: at m = 4 ``local_kv_heads`` replicates
  the KV heads) and an odd vocab (101, unsharded), under ``"seq"`` and
  (dense, GQA) ``"heads"``.  Four prompts of 13 / 16 / 7 / 22 tokens (odd
  lengths give a prompt cache sharded over heads, even ones over rows) are
  prefilled one by one and primed into 32-row caches, then 8 greedy
  ``build_serve_step`` steps run with per-slot positions that cross the
  slice boundaries (16 at m = 2; 8, 16, 24 at m = 4);
* each rank's primed caches equal its slice of one process's, row by row;
  the greedy tokens equal one process's and ``repro``'s exactly; the
  whole-vocabulary logits are within ``LOGIT_RTOL`` of their row's largest
  magnitude; ``verify_step`` over 4 positions gives bit for bit the 4
  decode steps' logits.

Tolerances: the ranks' matrix products are narrower than one process's
(their heads, their ``ff`` columns, their vocab rows) and their sums over
``model`` add partial products in another order, and the sequence-sharded
decode combines slices where one process combines 64-slot chunks; in
float32 that moves a logit by a few 1e-7 of the row's largest (observed
up to 6e-7), so ``LOGIT_RTOL`` is 1e-5 of it.  A primed cache row differs
from one process's by the K/V projection's narrower product only: within
``CACHE_RTOL`` (1e-6) of the leaf's largest magnitude (observed 1.2e-6 on
values up to 3.9: a few float32 ulps, 3e-7 of it).  Against ``repro``
(XLA's CPU products) the same 1e-5 of the row's largest holds.

Rank functions are module-level (the children unpickle them by importing
this file), and JAX is imported only inside the tests that use it.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_NAMES, get_config, reduced_config  # noqa: E402
from repro_torch.dist.sharding import use_mesh  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.launch import mesh as lm  # noqa: E402
from repro_torch.models import layer_kinds  # noqa: E402
from repro_torch.models.param import local_shape  # noqa: E402

PROMPT_LENS = (13, 16, 7, 22)
MAX_SEQ = 32
STEPS = 8
VERIFY_T = 4
LOGIT_RTOL = 1e-5
CACHE_RTOL = 1e-6

CASES = {  # name -> (variant, kv_shard)
    "dense-seq": ("dense", "seq"),
    "dense-heads": ("dense", "heads"),
    "gqa-seq": ("gqa", "seq"),
    "gqa-heads": ("gqa", "heads"),
    "odd-vocab-seq": ("odd-vocab", "seq"),
}


class FakeMesh:
    """A mesh-like object: the axis sizes, no process group."""

    def __init__(self, **sizes):
        self.shape = sizes


def _cfg(name: str):
    """Reduced deepseek-7b in float32 with the case's variant and
    ``kv_shard``: GQA has 2 KV heads of 4, the odd vocab 101 classes
    unpadded."""
    variant, kv_shard = CASES[name]
    cfg = reduced_config("deepseek-7b").replace(dtype="float32", kv_shard=kv_shard)
    if variant == "gqa":
        cfg = cfg.replace(n_kv_heads=2)
    elif variant == "odd-vocab":
        cfg = cfg.replace(vocab=101, vocab_pad_multiple=1)
    return cfg


def _prompts(cfg) -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, size=L).astype(np.int32) for L in PROMPT_LENS]


def _serve(cfg, tree) -> dict:
    """The case's serving run on the active mesh (or one process off it),
    from ``repro``'s weights ``tree``: each prompt prefilled
    (``build_prefill_fn``) and primed, the primed caches copied into a pool
    of 4 slots (``init_cache``), ``STEPS`` greedy ``build_serve_step``
    steps, the same steps through ``decode_step`` fed those tokens (the
    whole logits: ``gather_logits``), and ``verify_step`` over the first
    ``VERIFY_T`` tokens against those decode steps' logits bit for bit."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models import ShapeSpec, decode_step, gather_logits, init_cache, verify_step
    from repro_torch.runtime.serve import build_prefill_fn, build_serve_step, prime_cache

    model = params_from_numpy(tree, cfg, device="cpu")
    prompts = _prompts(cfg)
    prefill_fn = build_prefill_fn(cfg)
    primed, first = [], []
    for p in prompts:
        tok, caches = prefill_fn(model, {"tokens": torch.from_numpy(p[None])})
        primed.append(prime_cache(cfg, caches, len(p), MAX_SEQ))
        first.append(tok)

    def pool():
        c = init_cache(cfg, len(prompts), MAX_SEQ, device="cpu")
        for b, pc in enumerate(primed):
            for k in c:
                c[k][:, b:b + 1] = pc[k]
        return c

    lens = torch.tensor(PROMPT_LENS, dtype=torch.int32)
    step = build_serve_step(cfg, ShapeSpec("t", "decode", MAX_SEQ, len(prompts)))
    tok, caches, toks = torch.cat(first), pool(), []
    toks.append(tok)
    for i in range(STEPS):
        tok, caches = step(model, tok, caches, lens + i)
        toks.append(tok)
    caches, local, logits = pool(), [], []
    for i in range(STEPS):
        lg, caches = decode_step(model, toks[i], caches, lens + i, cfg)
        local.append(lg)
        logits.append(gather_logits(model, lg))
    vl, _ = verify_step(model, torch.cat(toks[:VERIFY_T], dim=1), pool(), lens, cfg)
    return {"toks": torch.cat(toks, dim=1).numpy(), "logits": torch.stack(logits)[:, :, 0].numpy(),
            "verify_bitexact": all(torch.equal(vl[:, j], local[j][:, 0]) for j in range(VERIFY_T)),
            "primed": [{k: v.numpy().copy() for k, v in p.items()} for p in primed],
            "seq_len": getattr(caches, "seq_len", None)}


def _rank_cases(trees: dict) -> dict:
    return {name: _serve(_cfg(name), trees[name]) for name in CASES}


def _jax_trees() -> dict:
    """``repro``'s initial weights of each case (numpy trees)."""
    import jax

    from repro.models import init_params as jax_init_params
    from repro_torch.models.config import ArchConfig

    out = {}
    for name in CASES:
        jcfg = _jax_cfg(_cfg(name))
        out[name] = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
        assert dataclasses.asdict(ArchConfig(**dataclasses.asdict(jcfg))) == dataclasses.asdict(_cfg(name))
    return out


def _jax_cfg(cfg):
    from repro.models.config import ArchConfig as JaxArchConfig

    return JaxArchConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def trees():
    return _jax_trees()


@pytest.fixture(scope="module")
def one_process(trees):
    with use_mesh(None):
        return {name: _serve(_cfg(name), trees[name]) for name in CASES}


@pytest.fixture(scope="module")
def two_ranks(trees):
    return lm.spawn_mesh(functools.partial(_rank_cases, trees), 2, (1, 2), ("data", "model"), timeout=300.0)


@pytest.fixture(scope="module")
def four_ranks(trees):
    return lm.spawn_mesh(functools.partial(_rank_cases, trees), 4, (1, 4), ("data", "model"), timeout=300.0)


@pytest.fixture(scope="module")
def repro_tokens(trees):
    """``repro``'s own greedy run of each case on the same weights: each
    prompt through ``repro.models.prefill`` and ``prime_cache``, the slots
    concatenated, ``STEPS`` ``decode_step``s with per-slot positions →
    (tokens (B, STEPS + 1), logits (STEPS, B, V))."""
    import jax.numpy as jnp

    from repro.models import decode_step as jax_decode_step
    from repro.models import prefill as jax_prefill
    from repro.runtime.serve import prime_cache as jax_prime_cache

    out = {}
    for name in CASES:
        cfg = _cfg(name)
        jcfg, params = _jax_cfg(cfg), trees[name]
        caches, first = [], []
        for p in _prompts(cfg):
            lg, c = jax_prefill(params, {"tokens": jnp.asarray(p[None])}, jcfg)
            caches.append(jax_prime_cache(jcfg, c, len(p), MAX_SEQ))
            first.append(np.asarray(jnp.argmax(lg[:, -1], axis=-1), np.int32))
        cache = {k: jnp.concatenate([c[k] for c in caches], axis=1) for k in ("k", "v")}
        tok = np.stack(first)
        toks, logits = [tok], []
        for i in range(STEPS):
            pos = np.asarray([L + i for L in PROMPT_LENS], np.int32)
            lg, cache = jax_decode_step(params, jnp.asarray(tok), cache, jnp.asarray(pos), jcfg)
            logits.append(np.asarray(lg[:, 0], np.float32))
            tok = np.asarray(jnp.argmax(lg[:, 0], axis=-1), np.int32)[:, None]
            toks.append(tok)
        out[name] = (np.concatenate(toks, axis=1), np.stack(logits))
    return out


# ---------------------------------------------------------------------------
# The specs (no process group).
# ---------------------------------------------------------------------------

PROD_MESHES = {"pod_16x16": dict(data=16, model=16), "multipod_2x16x16": dict(pod=2, data=16, model=16)}
ATTN_ARCHS = [a for a in ARCH_NAMES
              if set(layer_kinds(get_config(a))) == {"attn"} and get_config(a).frontend is None]


@pytest.mark.parametrize("mesh", sorted(PROD_MESHES))
@pytest.mark.parametrize("kv_shard", ["seq", "heads"])
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_cache_shardings_equal_repro(arch, kv_shard, mesh):
    """``cache_shardings`` of the decode_32k and long_500k caches equals
    ``repro``'s (``safe_spec`` of ``repro``'s ``cache_defs``, which take
    their axes from ``kv_cache_axes``)."""
    from repro.configs import get_config as jax_get_config
    from repro.dist.sharding import safe_spec as jax_safe_spec
    from repro.models.transformer import cache_defs as jax_cache_defs
    from repro_torch.runtime.serve import cache_shardings

    fake = FakeMesh(**PROD_MESHES[mesh])
    for batch, seq in ((128, 32_768), (1, 524_288), (3, 777)):
        jcfg = jax_get_config(arch).replace(kv_shard=kv_shard)
        want = {k: tuple(jax_safe_spec(d.shape, d.axes, mesh=fake))
                for k, d in jax_cache_defs(jcfg, batch, seq).items()}
        got = {k: tuple(s) for k, s in cache_shardings(get_config(arch).replace(kv_shard=kv_shard), batch, seq,
                                                          fake).items()}
        assert got == want, (batch, seq)


def test_the_cache_axes_follow_kv_shard():
    from repro.models.attention import kv_cache_axes as jax_kv_cache_axes
    from repro_torch.models.attention import kv_cache_axes

    for kv_shard in ("seq", "heads"):
        cfg = reduced_config("deepseek-7b").replace(kv_shard=kv_shard)
        assert kv_cache_axes(cfg) == jax_kv_cache_axes(cfg)
    assert kv_cache_axes() == ("batch", "kv_seq", "kv_heads", None)


@pytest.mark.parametrize("kv_shard", ["seq", "heads"])
def test_abstract_cache_holds_the_local_shapes(kv_shard):
    """decode_32k's caches of full-width deepseek-7b (32 KV heads) and
    qwen1.5-110b (8 KV heads: replicated at model 16) on (data 16, model
    16): each leaf at its local shape — (8, 2048, KH, Dh) a layer under
    ``"seq"``, (8, 32768, KH / 16 or KH, Dh) under ``"heads"`` — and a
    ``MeshCaches`` of 32768 global rows."""
    from repro_torch.models import MeshCaches, abstract_cache, cache_defs
    from repro_torch.runtime.serve import cache_shardings

    fake = FakeMesh(data=16, model=16)
    for arch in ("deepseek-7b", "qwen1.5-110b"):
        cfg = get_config(arch).replace(kv_shard=kv_shard)
        with use_mesh(fake):
            caches = abstract_cache(cfg, 128, 32_768)
        assert isinstance(caches, MeshCaches) and caches.seq_len == 32_768
        specs = cache_shardings(cfg, 128, 32_768, fake)
        KH = cfg.n_kv_heads
        want_kh = KH // 16 if (kv_shard == "heads" and KH % 16 == 0) else KH
        want_rows = 2048 if kv_shard == "seq" else 32_768
        for name, d in cache_defs(cfg, 128, 32_768).items():
            assert tuple(caches[name].shape) == local_shape(d.shape, specs[name], fake)
            assert tuple(caches[name].shape) == (cfg.n_layers, 8, want_rows, want_kh, cfg.head_dim), (arch, name)
    with use_mesh(FakeMesh(data=2, model=1)):  # no model axis: local batch rows, a plain dict
        caches = abstract_cache(reduced_config("deepseek-7b"), 4, 16)
    assert type(caches) is dict and caches["k"].shape[1] == 2


# ---------------------------------------------------------------------------
# The partial route's plain version.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_slices", [1, 2, 4])
def test_partial_slices_combined_equal_the_whole_cache(n_slices):
    """Slices of a (4, 64, 8, 16) cache (GQA 8 on 2 KV heads, float32)
    through the plain partial route, combined in slice order
    (``combine_partials``), equal the whole-cache plain route within 1e-6
    (float32 sums in another order).  Positions: past the last slot, inside
    the first slice (every later slice empty: lse -inf, output 0), on a
    slice boundary, and one that gives no valid slot at all (pos -1: the
    combine gives 0, never NaN)."""
    gen = torch.Generator().manual_seed(4)
    B, S, H, KH, D = 4, 64, 8, 2, 16
    q, k, v = (torch.randn(s, generator=gen) for s in ((B, 1, H, D), (B, S, KH, D), (B, S, KH, D)))
    Sl = S // n_slices
    pos = torch.tensor([S + 5, 3, Sl - 1, -1], dtype=torch.int32)
    outs, lses = zip(*(decode_ops.decode_attention(q, k[:, i * Sl:(i + 1) * Sl], v[:, i * Sl:(i + 1) * Sl], pos,
                                                   i * Sl, partial=True) for i in range(n_slices)))
    assert all(o.dtype == torch.float32 and o.shape == (B, 1, H, D) for o in outs)
    assert all(lse.shape == (B, H) for lse in lses)
    if n_slices > 1:
        assert torch.isinf(lses[-1][1]).all() and not outs[-1][1].any()  # pos 3: the last slice is empty
    assert torch.isinf(torch.stack(lses)[:, 3]).all()
    got = decode_ops.combine_partials(torch.stack(outs), torch.stack(lses))
    assert torch.isfinite(got).all() and not got[3].any()
    want = decode_ops.decode_attention(q, k, v, pos)
    torch.testing.assert_close(got[:3], want[:3], rtol=0, atol=1e-6)
    # the slice's lse is the log-sum-exp of its valid scaled scores
    s = torch.einsum("bhgd,bshd->bhgs", q.reshape(B, KH, H // KH, D), k) / math.sqrt(D)
    torch.testing.assert_close(lses[0][0], torch.logsumexp(s[0, :, :, :Sl], dim=-1).reshape(H), rtol=0, atol=1e-5)


def test_partial_route_work_list_follows_the_slice_offset():
    """The chunk plan of a slice counts its valid slots from its offset, so
    a slice's split depends on its positions alone."""
    assert decode_ops.chunk_plan([100, 10], 64, slot_offset=64) == [[(0, 37)], []]
    assert decode_ops.work_list([100, 10], 64, 2, slot_offset=64) == [(0, 0, 0), (0, 0, 1), (1, 0, 0), (1, 0, 1)]
    assert decode_ops.chunk_plan([200], 128) == decode_ops.chunk_plan([200], 128, slot_offset=0)


# ---------------------------------------------------------------------------
# 2 and 4 gloo ranks against one process and repro.
# ---------------------------------------------------------------------------

def _rank_slice(arr: np.ndarray, cfg, r: int, m: int) -> np.ndarray:
    """Rank ``r``'s part of one process's primed leaf (n, 1, S, KH, Dh)
    under ``cache_shardings`` on (data 1, model m)."""
    from repro_torch.runtime.serve import cache_shardings

    spec = cache_shardings(cfg, 1, MAX_SEQ, FakeMesh(data=1, model=m))["k"]
    index = []
    for n, entry in zip(arr.shape, spec):
        step = n // m if entry == "model" else n
        index.append(slice(r * step, (r + 1) * step) if entry == "model" else slice(None))
    return arr[tuple(index)]


def _check_primed(ranks, one, name, m):
    cfg = _cfg(name)
    for r, got in enumerate(ranks):
        for p, (g, w) in enumerate(zip(got[name]["primed"], one[name]["primed"])):
            for leaf in ("k", "v"):
                want = _rank_slice(w[leaf], cfg, r, m)
                assert g[leaf].shape == want.shape, (r, p, leaf)
                atol = CACHE_RTOL * np.abs(w[leaf]).max()
                rows = [i for i in range(want.shape[2])
                        if not np.allclose(g[leaf][:, :, i], want[:, :, i], rtol=0, atol=atol)]
                assert rows == [], f"rank {r}, prompt {p}, {leaf}: rows {rows} differ"


def _check_logits(got: np.ndarray, want: np.ndarray, what: str) -> None:
    scale = np.abs(want).max(axis=-1, keepdims=True)
    worst = float((np.abs(got - want) / scale).max())
    assert worst <= LOGIT_RTOL, f"{what}: {worst:.2e} of the row's largest"


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_prime_each_rows_slice(two_ranks, one_process, case):
    _check_primed(two_ranks, one_process, case, 2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_four_ranks_prime_each_rows_slice(four_ranks, one_process, case):
    _check_primed(four_ranks, one_process, case, 4)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_serve_steps_equal_one_process_and_repro(two_ranks, four_ranks, one_process, repro_tokens, case, m):
    ranks = two_ranks if m == 2 else four_ranks
    want_toks, want_logits = repro_tokens[case]
    np.testing.assert_array_equal(one_process[case]["toks"], want_toks)
    _check_logits(one_process[case]["logits"], want_logits, "one process against repro")
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[case]["toks"], one_process[case]["toks"], err_msg=f"rank {r}")
        np.testing.assert_array_equal(got[case]["toks"], want_toks, err_msg=f"rank {r} against repro")
        _check_logits(got[case]["logits"], one_process[case]["logits"], f"rank {r} against one process")
        _check_logits(got[case]["logits"], want_logits, f"rank {r} against repro")
        assert got[case]["seq_len"] == MAX_SEQ


@pytest.mark.parametrize("m", [2, 4])
def test_verify_step_is_bit_for_bit_the_decode_steps(two_ranks, four_ranks, one_process, m):
    ranks = two_ranks if m == 2 else four_ranks
    for name in CASES:
        assert one_process[name]["verify_bitexact"], name
        assert all(r[name]["verify_bitexact"] for r in ranks), name


def test_positions_cross_the_slice_boundaries():
    """The decode positions of the runs above pass from one rank's rows to
    the next at m = 2 and at m = 4."""
    for m in (2, 4):
        Sl = MAX_SEQ // m
        crossed = [L for L in PROMPT_LENS if (L - 1) // Sl != (L + STEPS - 1) // Sl]
        assert crossed, m
    assert any(L % 2 for L in PROMPT_LENS) and any(L % 4 == 0 for L in PROMPT_LENS)


def test_decode_on_a_model_axis_takes_mesh_caches():
    """A plain dict of caches (no global rows) is refused on a model axis:
    its local shapes cannot place it."""
    from repro_torch.dist.sharding import DryRunMesh
    from repro_torch.models import decode_step, init_params

    cfg = _cfg("dense-seq")
    with use_mesh(DryRunMesh({"data": 1, "model": 2})):
        model = init_params(cfg, 0, device="cpu")
        caches = {k: torch.zeros(cfg.n_layers, 1, 8, cfg.n_kv_heads, cfg.head_dim) for k in ("k", "v")}
        with pytest.raises(ValueError, match="MeshCaches"):
            decode_step(model, torch.zeros((1, 1), dtype=torch.int32), caches, 0, cfg)
