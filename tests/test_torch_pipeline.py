"""The port's pipeline (``repro_torch.runtime.pipeline``) against ``repro``'s
on the toy problem of ``tests/test_pipeline.py`` (weights and data from a
numpy seed) under both schedules, ``split_stages``, and a reduced
deepseek split into 2 stages of the port's layers against the port's
monolithic ``loss_fn`` gradients (fp32)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.runtime import pipeline as jpipe  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core import SpComputeEngine, SpWorkerTeamBuilder, trace_metrics  # noqa: E402
from repro_torch.models import init_params, loss_fn, set_trainable  # noqa: E402
from repro_torch.runtime.pipeline import (  # noqa: E402
    model_stages,
    named_grads,
    pipeline_value_and_grad,
    split_stages,
)

DEPTH, WIDTH, M, B = 4, 16, 4, 8


def _toy_arrays(seed=0):
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal((WIDTH, WIDTH)).astype(np.float32) * 0.3 for _ in range(DEPTH)]
    head = rng.standard_normal((WIDTH, 1)).astype(np.float32) * 0.3
    xs = rng.standard_normal((M, B, WIDTH)).astype(np.float32)
    ys = np.sin(xs.sum(-1, keepdims=True))
    return ws, head, xs, ys


def _torch_stage(p, x):
    return torch.tanh(x @ p["w"])


def _torch_head(p, x, mb):
    return torch.mean((x @ p["w"] - mb["y"]) ** 2)


def _jax_stage(p, x):
    return jnp.tanh(x @ p["w"])


def _jax_head(p, x, mb):
    return jnp.mean((x @ p["w"] - mb["y"]) ** 2)


def _run(pkg, schedule, ws, head, xs, ys):
    if pkg == "torch":
        arr, eng = torch.from_numpy, SpComputeEngine(SpWorkerTeamBuilder.team_of_cpu_workers(4))
        fns, fn_h, run = _torch_stage, _torch_head, pipeline_value_and_grad
    else:
        arr, eng = jnp.asarray, jcore.SpComputeEngine(jcore.SpWorkerTeamBuilder.team_of_cpu_workers(4))
        fns, fn_h, run = _jax_stage, _jax_head, jpipe.pipeline_value_and_grad
    try:
        return run([fns] * DEPTH, fn_h, [{"w": arr(w)} for w in ws], {"w": arr(head)},
                   [{"x": arr(xs[m]), "y": arr(ys[m])} for m in range(M)], eng, schedule=schedule)
    finally:
        eng.stop()


def _monolithic(ws, head, xs, ys):
    """The port's plain autograd over the whole toy model."""
    leaves = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    h = torch.from_numpy(head).requires_grad_(True)
    tot = 0.0
    for m in range(M):
        x = torch.from_numpy(xs[m])
        for w in leaves:
            x = torch.tanh(x @ w)
        tot = tot + torch.mean((x @ h - torch.from_numpy(ys[m])) ** 2)
    loss = tot / M
    return loss.detach(), torch.autograd.grad(loss, (*leaves, h))


@pytest.mark.parametrize("schedule", ["1f1b", "fifo"])
def test_pipeline_matches_repro_and_the_monolithic_grads(schedule):
    ws, head, xs, ys = _toy_arrays()
    loss, g_stages, g_head, tg = _run("torch", schedule, ws, head, xs, ys)
    j_loss, j_stages, j_head, _ = _run("jax", schedule, ws, head, xs, ys)
    ref_loss, ref = _monolithic(ws, head, xs, ys)
    assert loss.dtype == torch.float32
    for want_loss, want_stages, want_head in (
        (float(j_loss), [np.asarray(g["w"]) for g in j_stages], np.asarray(j_head["w"])),
        (float(ref_loss), [g.numpy() for g in ref[:-1]], ref[-1].numpy()),
    ):
        np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
        for g, r in zip(g_stages, want_stages):
            assert g["w"].dtype == torch.float32
            np.testing.assert_allclose(g["w"].numpy(), r, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g_head["w"].numpy(), want_head, rtol=1e-4, atol=1e-5)
    m = trace_metrics(tg)
    assert m["n_tasks"] == 2 * DEPTH * M + M  # F[s,m] + B[s,m] + L[m]
    names = {e["task"] for e in tg.trace_events}
    assert {"F[0,0]", "L[3]", "B[3,0]", "B[0,3]"} <= names


def test_split_stages():
    layers = {"w": torch.arange(8 * 3).reshape(8, 3)}
    stages = split_stages(layers, 4, 8)
    assert len(stages) == 4
    assert stages[0]["w"].shape == (2, 3)
    torch.testing.assert_close(torch.cat([s["w"] for s in stages]), layers["w"], rtol=0, atol=0)
    mods = torch.nn.ModuleList(torch.nn.Linear(2, 2) for _ in range(6))
    chunks = split_stages(mods, 3, 6)
    assert [len(c) for c in chunks] == [2, 2, 2]
    assert all(a is b for c, i in zip(chunks, (0, 2, 4)) for a, b in zip(c, list(mods)[i:i + 2]))
    with pytest.raises(ValueError, match="equal stages"):
        split_stages(layers, 3, 8)


@pytest.mark.parametrize("schedule", ["1f1b", "fifo"])
def test_reduced_deepseek_in_two_stages_matches_loss_fn(schedule):
    """Stage 0 = embedding + layer 0, stage 1 = layer 1, head = final norm +
    cross-entropy, 2 microbatches: the mean loss and every parameter's
    gradient equal the port's monolithic ``loss_fn`` autograd (fp32)."""
    cfg = reduced_config("deepseek-7b").replace(dtype="float32")
    model = set_trainable(init_params(cfg, 0, device="cpu"))
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (4, 17), generator=gen, dtype=torch.int32)
    mbs = [{"x": tokens[2 * m:2 * m + 2, :-1], "tokens": tokens[2 * m:2 * m + 2, :-1],
            "labels": tokens[2 * m:2 * m + 2, 1:]} for m in range(2)]
    stage_fns, stage_params, head_fn, head_params = model_stages(model, cfg, 2)
    eng = SpComputeEngine(SpWorkerTeamBuilder.team_of_cpu_workers(2))
    try:
        loss, g_stages, g_head, tg = pipeline_value_and_grad(
            stage_fns, head_fn, stage_params, head_params, mbs, eng, schedule=schedule)
    finally:
        eng.stop()
    assert trace_metrics(tg)["n_tasks"] == 2 * 2 * 2 + 2
    names, params = zip(*model.named_parameters())
    ref_loss = 0.0
    ref = [torch.zeros_like(p) for p in params]
    for mb in mbs:
        lm, _ = loss_fn(model, mb, cfg)
        for acc, g in zip(ref, torch.autograd.grad(lm / 2, params)):
            acc += g
        ref_loss += float(lm.detach()) / 2
    got = named_grads(g_stages, g_head, cfg.n_layers)
    assert set(got) == set(names)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5, atol=1e-5)
    for n, r in zip(names, ref):
        np.testing.assert_allclose(got[n].numpy(), r.numpy(), rtol=1e-5, atol=1e-5, err_msg=n)


def test_a_run_leaves_no_tensor_to_the_engine():
    """The engine keeps the graphs it has driven; a finished run leaves them
    empty cells, so the gradients go once the caller drops them."""
    import gc
    import weakref

    ws, head, xs, ys = _toy_arrays()
    eng = SpComputeEngine(SpWorkerTeamBuilder.team_of_cpu_workers(2))
    try:
        _, g_stages, g_head, tg = pipeline_value_and_grad(
            [_torch_stage] * DEPTH, _torch_head, [{"w": torch.from_numpy(w)} for w in ws],
            {"w": torch.from_numpy(head)}, [{"x": torch.from_numpy(xs[m]), "y": torch.from_numpy(ys[m])}
                                            for m in range(M)], eng)
        refs = [weakref.ref(g_stages[0]["w"]), weakref.ref(g_head["w"])]
        del g_stages, g_head, tg
        gc.collect()
        assert all(r() is None for r in refs)
    finally:
        eng.stop()
