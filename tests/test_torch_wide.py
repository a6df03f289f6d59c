"""The shapes the wide routes take, held against ``repro`` on the CPU.

The Pallas kernels set no bound on head, state or chunk width and take
bfloat16 at any width; the port's main CUDA routes do (head dims up to 256,
P <= 64, N <= 128, bfloat16 chunks up to 256 in whole 16-byte chunks), and
every shape past them takes a wide route (``csrc/*_wide.cu``).  On the CPU
each wrapper runs its plain version, so these tests hold the plain versions
against the Pallas kernels in interpret mode and against ``jax.vjp`` of
``repro``'s jnp code at those shapes, the wide routes' launch plans against
the outputs they must cover, the route chooser against the shapes the
kernel table of ``PERF.md`` times (which must keep their main routes), the
meta route's FLOP counts, and two reduced models with such shapes against
``repro`` on bridged weights.  ``test_torch_cuda_kernels.py`` holds the
wide kernels against the plain versions on the card.
"""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.kernels.decode_attention.kernel import decode_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.ssd.kernel import ssd_intra_chunk_pallas  # noqa: E402
from repro.kernels.ssd.ref import ssd_chunk_ref as jax_ssd_chunk_ref  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models.attention import blockwise_attention, reference_attention  # noqa: E402
from repro.runtime.serve import prime_cache as jax_prime_cache  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.runtime.serve import prime_cache  # noqa: E402

pytestmark = pytest.mark.timeout(300)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py's tolerances
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)  # test_torch_model.py's
GRAD_RTOL = 2e-6  # test_torch_train.py's flash gradients, of each output's largest magnitude
SSD_GRAD_RTOL = 1e-5  # test_torch_ssd_bwd.py's


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _both(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _ssd_close(got, want) -> None:
    """ssd outputs are float32 sums of up to cs·N products: the limit scales
    with the output (5e-5 of its largest magnitude, 1e-4 relative)."""
    got, want = _np(got), _np(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-5 * np.abs(want).max())


def _scaled_close(got, want, rtol: float, name: str = "") -> None:
    got, want = _np(got), _np(want)
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max() + 1e-30, err_msg=name)


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels, at the wide shapes
# ---------------------------------------------------------------------------

# (dtype, H, KH, L, Dh, Dv, bq, bk): head dims above 256 (Dh != Dv), and a
# head of 100 (not a multiple of 8) in bfloat16
FLASH_CASES = [
    ("float32", 2, 1, 64, 320, 288, 32, 32),
    ("bfloat16", 2, 1, 64, 320, 288, 32, 32),
    ("bfloat16", 4, 2, 64, 100, 100, 16, 16),
    ("float32", 4, 2, 64, 100, 100, 16, 16),
]


@pytest.mark.parametrize("causal,window,q_offset", [(True, None, 0), (True, 40, 0), (False, None, 0)])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_wide_flash_plain_matches_pallas(case, causal, window, q_offset):
    dtype, H, KH, L, Dh, Dv, bq, bk = case
    rng = np.random.default_rng(0)
    qn = rng.standard_normal((1, H, L, Dh), np.float32)
    kn = rng.standard_normal((1, KH, L, Dh), np.float32)
    vn = rng.standard_normal((1, KH, L, Dv), np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (qn, kn, vn))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    pallas = flash_attention_pallas(qj, kj, vj, block_q=bq, block_kv=bk, interpret=True, **kw)
    out = flash_ops.flash_attention(qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2), **kw)
    assert out.dtype == DTYPES[dtype][1] and tuple(out.shape) == (1, L, H, Dv)
    np.testing.assert_allclose(_np(out.transpose(1, 2)), _np(pallas), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 77, 127])
@pytest.mark.parametrize("Dh,Dv", [(320, 320), (512, 288)])
def test_wide_decode_plain_matches_pallas(dtype, pos, Dh, Dv):
    rng = np.random.default_rng(2)
    B, H, KH, S = 2, 4, 2, 128
    qn = rng.standard_normal((B, H, Dh), np.float32)
    kn = rng.standard_normal((B, KH, S, Dh), np.float32)
    vn = rng.standard_normal((B, KH, S, Dv), np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (qn, kn, vn))
    pallas = decode_attention_pallas(qj, kj, vj, jnp.int32(pos), block_s=64, interpret=True)
    out = decode_ops.decode_attention(qt[:, None], kt.transpose(1, 2), vt.transpose(1, 2),
                                      torch.full((B,), pos, dtype=torch.int32))[:, 0]
    np.testing.assert_allclose(_np(out), _np(pallas), **TOL[dtype])


def _chunk_inputs(cs, P, N, *, BH=3, nc=2, seed=2, dt_shift=-1.0, decay=0.4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BH, nc, cs, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((BH, nc, cs)) + dt_shift)).astype(np.float32)
    cum = np.cumsum(-dt * decay, axis=2).astype(np.float32)
    B = rng.standard_normal((BH, nc, cs, N)).astype(np.float32)
    C = rng.standard_normal((BH, nc, cs, N)).astype(np.float32)
    return x, dt, cum, B, C


# (cs, P, N, dtype): P above 64 and N above 128, a chunk above 256 (in
# bfloat16 past the tensor-core route's 256), and bfloat16 widths that are
# not multiples of 8
SSD_CASES = [(48, 96, 160, "float32"), (320, 16, 16, "float32"), (320, 16, 16, "bfloat16"),
             (40, 20, 12, "bfloat16")]


@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_wide_ssd_plain_matches_pallas(case):
    cs, P, N, dtype = case
    x, dt, cum, B, C = _chunk_inputs(cs, P, N)
    xj, xt = _both(x, dtype)
    Bj, Bt = _both(B, dtype)
    Cj, Ct = _both(C, dtype)
    jy, jst = ssd_intra_chunk_pallas(xj, jnp.asarray(dt), jnp.asarray(cum), Bj, Cj, interpret=True)
    ty, tst = ssd_ops.ssd_intra_chunk(xt, torch.from_numpy(dt), torch.from_numpy(cum), Bt, Ct)
    assert tuple(ty.shape) == tuple(jy.shape) and tuple(tst.shape) == tuple(jst.shape)
    _ssd_close(ty, jy)
    _ssd_close(tst, jst)


# ---------------------------------------------------------------------------
# the backward twins against jax.vjp of repro's jnp code
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["custom_vjp", "reference"])
@pytest.mark.parametrize("Dh,Dv,causal,window", [(320, 288, True, None), (320, 288, True, 20), (100, 100, False, None)])
def test_wide_attention_bwd_ref_matches_jax_vjp(Dh, Dv, causal, window, route):
    """Output and (dq, dk, dv) of the plain versions against ``jax.vjp`` of
    ``repro``'s custom-VJP flash attention and of its reference attention,
    float32, within 2e-6 of each output's largest magnitude."""
    rng = np.random.default_rng(3)
    Lq, Lk, H, KH = 48, 64, 4, 2
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((2, Lq, H, Dh), (2, Lk, KH, Dh), (2, Lk, KH, Dv), (2, Lq, H, Dv)))
    kw = dict(causal=causal, window=window, q_offset=16)
    if route == "custom_vjp":
        fn = lambda q, k, v: blockwise_attention(q, k, v, block_kv=16, mode="masked", **kw)  # noqa: E731
    else:
        fn = lambda q, k, v: reference_attention(q, k, v, **kw)  # noqa: E731
    jout, vjp = jax.vjp(fn, q, k, v)
    want = (jout,) + vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = flash_ops.attention_fwd_ref(tq, tk, tv, **kw)
    got = (out,) + flash_ops.attention_bwd_ref(tq, tk, tv, out, lse, tdo, **kw)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        _scaled_close(g, w, GRAD_RTOL, name)


def _jax_chunk_vjp(arrs, dy, dS):
    """``jax.vjp`` of ``repro``'s one-chunk reference, vmapped over (BH, nc)."""
    f = jax.vmap(jax.vmap(jax_ssd_chunk_ref))
    _, vjp = jax.vjp(f, *map(jnp.asarray, arrs))
    return [np.asarray(t) for t in vjp((jnp.asarray(dy), jnp.asarray(dS)))]


@pytest.mark.parametrize("cs,P,N", sorted({c[:3] for c in SSD_CASES}), ids=lambda v: str(v))
def test_wide_ssd_bwd_ref_matches_jax_vjp(cs, P, N):
    """The plain backward (``ssd_chunk_bwd_ref``, the wide kernel's twin)
    against ``jax.vjp`` of ``repro``'s chunk reference, float32, each
    gradient within 1e-5 of its largest magnitude."""
    arrs = _chunk_inputs(cs, P, N, seed=4)
    rng = np.random.default_rng(5)
    dy = rng.standard_normal(arrs[0].shape).astype(np.float32)
    dS = rng.standard_normal(arrs[0].shape[:2] + (N, P)).astype(np.float32)
    want = _jax_chunk_vjp(arrs, dy, dS)
    got = ssd_ops.ssd_chunk_bwd_ref(*map(torch.from_numpy, arrs), torch.from_numpy(dy), torch.from_numpy(dS))
    for name, g, w in zip(("dx", "ddt", "dcum", "dB", "dC"), got, want):
        _scaled_close(g, w, SSD_GRAD_RTOL, name)


# ---------------------------------------------------------------------------
# the route chooser and the wide routes' launch plans
# ---------------------------------------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32
# the shapes PERF.md's kernel table times on the main routes: (Dh, Dv)
FLASH_TABLE = [(128, 128), (256, 256), (96, 64), (80, 80)]
DECODE_TABLE = [(128, 128), (256, 256)]
SSD_TABLE = [(256, 64, 128)]  # (cs, P, N)


def test_route_chooser_keeps_the_kernel_table_on_the_main_routes():
    """The table's bfloat16 shapes stay on the tensor-core routes; float32
    takes the wide (SIMT) route of flash and ssd at every shape, and
    decode's main route in either dtype."""
    for Dh, Dv in FLASH_TABLE:
        assert flash_ops.route(Dh, Dv, BF16) == "main", (Dh, Dv)
        assert flash_ops.route(Dh, Dv, F32) == "wide", (Dh, Dv)
    for Dh, Dv in DECODE_TABLE:
        assert decode_ops.route(Dh, Dv) == "main"
    for cs, P, N in SSD_TABLE:
        assert ssd_ops.route(cs, P, N, BF16) == "main"
        assert ssd_ops.route(cs, P, N, F32) == "wide"
    assert flash_ops.route(100, 36, F32, aligned=False) == "wide"
    assert ssd_ops.route(1000, 20, 12, F32, aligned=False) == "wide"


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_route_chooser_sends_every_refused_shape_wide(dtype):
    for Dh, Dv in ((257, 64), (64, 257), (320, 288), (512, 512), (4096, 100)):
        assert flash_ops.route(Dh, Dv, dtype) == "wide"
        assert decode_ops.route(Dh, Dv) == "wide"
    for cs, P, N in ((48, 96, 160), (256, 65, 128), (256, 64, 129), (512, 128, 256)):
        assert ssd_ops.route(cs, P, N, dtype) == "wide"
    if dtype == BF16:
        assert flash_ops.route(100, 100, dtype, aligned=False) == "wide"
        assert ssd_ops.route(320, 16, 16, dtype) == "wide"
        assert ssd_ops.route(40, 20, 12, dtype, aligned=False) == "wide"


def test_route_reads_the_layout_of_bf16_tensors():
    """An aligned head passes the tensor-core rule; a head of 100, a slice
    one element in and a head stride of 68 do not (they take the wide
    route in bfloat16)."""
    ok = torch.zeros(1, 8, 2, 64, dtype=BF16)
    assert flash_ops.meets_tensor_core_layout(q=ok, k=ok, v=ok)
    assert not flash_ops.meets_tensor_core_layout(q=torch.zeros(1, 8, 2, 100, dtype=BF16))
    assert not flash_ops.meets_tensor_core_layout(q=torch.zeros(1, 8, 2, 68, dtype=BF16)[..., :64])
    assert not flash_ops.meets_tensor_core_layout(q=torch.zeros(2 * 8 * 64 + 1, dtype=BF16)[1:].view(2, 8, 1, 64))


def _cover(shape, blocks) -> np.ndarray:
    n = np.zeros(shape, np.int64)
    for sl in blocks:
        n[sl] += 1
    return n


@pytest.mark.parametrize("Lq,H,Dv", [(1, 1, 1), (130, 3, 288), (64, 2, 512), (65, 1, 600), (2048, 8, 512)])
def test_flash_wide_fwd_plan_covers_every_output_once(Lq, H, Dv):
    plan = flash_ops.wide_fwd_plan(Lq, H, Dv)
    n = _cover((Lq, H, Dv), [np.s_[q0:q0 + 64, h, c0:c0 + w] for q0, h, c0, w in plan])
    assert (n == 1).all()
    # lse: slice 0 of each (query tile, head)
    assert sorted((q0, h) for q0, h, c0, _ in plan if c0 == 0) == [
        (q0, h) for q0 in range(0, Lq, 64) for h in range(H)]


@pytest.mark.parametrize("Lq,Lk,H,KH,Dh,Dv", [(130, 200, 4, 2, 320, 288), (1, 129, 8, 8, 512, 512),
                                              (65, 65, 2, 1, 300, 600), (100, 100, 4, 2, 100, 100)])
def test_flash_wide_bwd_plan_covers_every_gradient_once(Lq, Lk, H, KH, Dh, Dv):
    plan = flash_ops.wide_bwd_plan(Lq, Lk, H, KH, Dh, Dv)
    shapes = {"dk": (Lk, KH, Dh), "dv": (Lk, KH, Dv), "dq": (Lq, H, Dh)}
    for what, shape in shapes.items():
        n = _cover(shape, [np.s_[r0:r0 + 64, h, c0:c0 + w] for o, r0, h, c0, w in plan if o == what])
        assert (n == 1).all(), what


@pytest.mark.parametrize("cs,P,N", [(1, 1, 1), (48, 96, 160), (320, 16, 16), (40, 20, 12), (512, 128, 256)])
def test_ssd_wide_plans_cover_every_output_once(cs, P, N):
    fwd = ssd_ops.wide_fwd_plan(cs, P, N)
    assert (_cover((cs, P), [np.s_[b.row0:b.row0 + b.rows, b.col0:b.col0 + b.cols]
                             for b in fwd if b.output == "y"]) == 1).all()
    assert (_cover((N, P), [np.s_[b.row0:b.row0 + b.rows, b.col0:b.col0 + b.cols]
                            for b in fwd if b.output == "state"]) == 1).all()
    bwd = ssd_ops.wide_bwd_plan(cs, P, N)
    for what, shape in (("dx", (cs, P)), ("dB", (cs, N)), ("dC", (cs, N)), ("ddt", (cs, 1)), ("dcum", (cs, 1))):
        n = _cover(shape, [np.s_[b.row0:b.row0 + b.rows, b.col0:b.col0 + b.cols] for b in bwd if b.output == what])
        assert (n == 1).all(), what
    assert all(b.rows <= 64 and b.cols <= 64 for b in fwd + bwd if b.output not in ("ddt", "dcum"))


@pytest.mark.parametrize("S", [1, 70, 300])
@pytest.mark.parametrize("Dv", [257, 320, 600])
def test_decode_wide_plan_covers_every_slot_and_column_once(S, Dv):
    """The wide decode route keeps the main route's work list (chunks of
    valid slots) and its threads stride the head dim: every (valid slot,
    column) once."""
    pos = [0, S // 2, S - 1]
    for p, chunks in zip(pos, decode_ops.chunk_plan(pos, S)):
        slots = np.zeros(S, np.int64)
        for s0, s1 in chunks:
            slots[s0:s1] += 1
        assert (slots[:p + 1] == 1).all() and (slots[p + 1:] == 0).all()
    cols = np.zeros(Dv, np.int64)
    for c in decode_ops.wide_columns(Dv):
        cols[list(c)] += 1
    assert (cols == 1).all()


# ---------------------------------------------------------------------------
# the meta route takes the wide shapes and counts their operations
# ---------------------------------------------------------------------------

def test_meta_route_counts_the_wide_shapes():
    calls = []
    meta = dict(device="meta", dtype=BF16)
    with dispatch.meta_kernel_calls(lambda *a: calls.append(a)):
        q, k, v = torch.empty(2, 64, 8, 512, **meta), torch.empty(2, 64, 8, 512, **meta), torch.empty(2, 64, 8, 288, **meta)
        out, lse = flash_ops.flash_attention(q, k, v, return_lse=True)
        flash_ops.flash_attention_bwd(q, k, v, out, lse, out)
        decode_ops.decode_attention(q[:, :1], k, v, torch.empty(2, dtype=torch.int32, device="meta"))
        x = torch.empty(1, 12, 2, 512, 128, **meta)
        B = torch.empty(1, 1, 2, 512, 256, **meta)
        dt = torch.empty(1, 12, 2, 512, device="meta")
        y, st = ssd_ops.ssd_intra_chunk(x, dt, dt, B, B)
        ssd_ops.ssd_intra_chunk_bwd(x, dt, dt, B, B, y, st)
    assert out.shape == (2, 64, 8, 288) and y.shape == (1, 12, 2, 512, 128) and st.shape == (1, 12, 2, 256, 128)
    pairs = flash_ops.mask_pairs(64, 64, True, None, 0)
    assert [(c[0], c[2]) for c in calls] == [
        ("flash_attention", flash_ops.fwd_flops(2, 8, 512, 288, pairs)),
        ("flash_attention_bwd", flash_ops.bwd_flops(2, 8, 512, 288, pairs)),
        ("decode_attention", decode_ops.flops(2, 64, 8, 512, 288)),
        ("ssd_intra_chunk", ssd_ops.fwd_flops(1, 12, 2, 512, 128, 256)),
        ("ssd_intra_chunk_bwd", ssd_ops.bwd_flops(1, 12, 2, 512, 128, 256)),
    ]
    for counter in (flash_ops.wide_launches, flash_ops.wide_bwd_launches, decode_ops.wide_launches,
                    ssd_ops.wide_launches, ssd_ops.wide_bwd_launches):
        assert counter.count == 0


# ---------------------------------------------------------------------------
# reduced models at the wide shapes against repro
# ---------------------------------------------------------------------------

def _dense_pair():
    """Reduced deepseek-7b with two heads of 320 (the flash and decode wide
    shapes), float32, on ``repro``'s weights."""
    wide = dict(dtype="float32", head_dim=320, n_heads=2, n_kv_heads=2)
    jcfg = jax_reduced_config("deepseek-7b").replace(**wide)
    cfg = reduced_config("deepseek-7b").replace(**wide)
    return jcfg, cfg


def _ssm_pair():
    """Reduced mamba2-130m with SSD head dim P = 96 and state N = 160 (two
    heads of 96 on d_model 96), float32."""
    out = []
    for get in (jax_reduced_config, reduced_config):
        c = get("mamba2-130m")
        out.append(c.replace(dtype="float32", d_model=96, ssm=dataclasses.replace(c.ssm, head_dim=96, d_state=160)))
    return tuple(out)


@pytest.fixture(scope="module", params=["deepseek-7b+head320", "mamba2-130m+P96+N160"])
def wide_pair(request):
    jcfg, cfg = _dense_pair() if request.param.startswith("deepseek") else _ssm_pair()
    assert repr(jcfg) == repr(cfg)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, model


def test_wide_model_logits_and_greedy_tokens_match_repro(wide_pair):
    """Prefill logits within 1e-4, then 4 greedy decode steps per package
    (each fed its own argmax): logits within 1e-4 and the same tokens."""
    jcfg, jparams, cfg, model = wide_pair
    if cfg.ssm is not None:
        assert (cfg.ssm.expand * cfg.d_model) // cfg.ssm.head_dim == 2 and cfg.ssm.d_state == 160
    else:
        assert cfg.head_dim == 320
    toks = np.random.default_rng(7).integers(0, cfg.vocab, size=(2, 13)).astype(np.int32)
    jl, jc = jax_prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = tm.prefill(model, {"tokens": torch.from_numpy(toks)}, cfg)
    np.testing.assert_allclose(_np(tl), _np(jl), **MODEL_TOL)
    max_seq = 24
    jc, tc = jax_prime_cache(jcfg, jc, 13, max_seq), prime_cache(cfg, tc, 13, max_seq)
    jtok = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    ttok = torch.argmax(tl[:, -1], dim=-1).to(torch.int32)[:, None]
    jstream, tstream = [jtok[:, 0].tolist()], [ttok[:, 0].tolist()]
    for step in range(4):
        pos = np.full((2,), 13 + step, np.int32)
        jl, jc = jax_decode_step(jparams, jnp.asarray(jtok), jc, jnp.asarray(pos), jcfg)
        tl, tc = tm.decode_step(model, ttok, tc, torch.from_numpy(pos), cfg)
        np.testing.assert_allclose(_np(tl), _np(jl), **MODEL_TOL)
        jtok = np.asarray(jnp.argmax(jl[:, 0], axis=-1), np.int32)[:, None]
        ttok = torch.argmax(tl[:, 0], dim=-1).to(torch.int32)[:, None]
        jstream.append(jtok[:, 0].tolist())
        tstream.append(ttok[:, 0].tolist())
    assert tstream == jstream
