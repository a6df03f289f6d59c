"""One dry-run cell through both packages: ``repro``'s lowering (XLA's
memory and cost analyses and its collectives, on placeholder host devices)
beside the port's model of it (``repro_torch.launch.dryrun.model_cell``).

    PYTHONPATH=src python tools/dryrun_vs_xla.py --arch deepseek-7b --shape train_4k
    PYTHONPATH=src python tools/dryrun_vs_xla.py --arch deepseek-7b --shape train_4k --set dtype=float32
    PYTHONPATH=src python tools/dryrun_vs_xla.py --reduced --mesh 2,2 --seq 128 --batch 8 --set logits_chunk=32

The mesh's axes are made ``AxisType.Auto``: the JAX this repository runs
makes Explicit axes by default, on which ``repro``'s vocab-sharded
embedding gather does not lower (``repro.launch.dryrun`` itself therefore
fails on it).  The last line is one JSON object of both sides' numbers.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--shape", default="train_4k", help="a SHAPES name (ignored with --seq / --batch)")
    ap.add_argument("--reduced", action="store_true", help="the arch's reduced config")
    ap.add_argument("--mesh", default="16,16", help="data,model or pod,data,model sizes")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--set", action="append", default=[], help="config override key=value")
    args = ap.parse_args(argv)
    sizes = tuple(int(x) for x in args.mesh.split(","))
    axes = ("data", "model") if len(sizes) == 2 else ("pod", "data", "model")
    # placeholder host devices: before JAX is imported
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={math.prod(sizes)} " + os.environ.get(
        "XLA_FLAGS", "")
    import jax
    from jax.sharding import AxisType

    from repro.configs import reduced_config as jax_reduced
    from repro.dist.sharding import use_mesh as jax_use_mesh
    from repro.launch.dryrun import collective_stats
    from repro.launch.dryrun import config_for_dryrun as jax_config_for_dryrun
    from repro.models import abstract_inputs
    from repro.models.config import SHAPES as JAX_SHAPES
    from repro.models.config import ShapeSpec as JaxShapeSpec
    from repro.runtime.train import abstract_train_state, build_train_step
    from repro_torch.configs import reduced_config
    from repro_torch.dist.sharding import DryRunMesh
    from repro_torch.launch import dryrun
    from repro_torch.models import SHAPES, ShapeSpec

    overrides = dryrun._parse_set(args.set)
    n_mb = int(overrides.pop("n_microbatches", 1))
    if args.reduced:
        jcfg, cfg = jax_reduced(args.arch).replace(**overrides), reduced_config(args.arch).replace(**overrides)
    else:
        jcfg, cfg = jax_config_for_dryrun(args.arch, overrides), dryrun.config_for_dryrun(args.arch, overrides)
    if args.seq or args.batch:
        base = SHAPES[args.shape]
        seq, batch = args.seq or base.seq_len, args.batch or base.global_batch
        jshape, shape = JaxShapeSpec("cell", "train", seq, batch), ShapeSpec("cell", "train", seq, batch)
    else:
        jshape, shape = JAX_SHAPES[args.shape], SHAPES[args.shape]
    if shape.kind != "train":
        ap.error("train cells only")
    mesh = jax.make_mesh(sizes, axes, axis_types=(AxisType.Auto,) * len(sizes))
    with jax_use_mesh(mesh):
        art = build_train_step(jcfg, n_microbatches=n_mb, donate=True)
        compiled = art.step_fn.lower(abstract_train_state(jcfg), abstract_inputs(jcfg, jshape)).compile()
    ma = compiled.memory_analysis()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    coll = collective_stats(compiled.as_text())
    xla = {"argument": ma.argument_size_in_bytes, "alias": ma.alias_size_in_bytes,
           "temp": ma.temp_size_in_bytes, "flops": float(ca["flops"]),
           "collectives": {"count": coll["total_count"], "bytes": coll["total_bytes"]}}
    rec = dryrun.model_cell(cfg, shape, DryRunMesh(dict(zip(axes, sizes))), n_microbatches=n_mb)
    port = {"argument": rec["memory"]["argument_size_in_bytes"], "alias": rec["memory"]["alias_size_in_bytes"],
            "temp": rec["memory"]["temp_size_in_bytes"], "flops_scan_once": rec["cost"]["flops_scan_once"],
            "collectives_scan_once": {"count": rec["collectives"]["scan_once"]["total_count"],
                                      "bytes": rec["collectives"]["scan_once"]["total_bytes"]},
            "peak_terms": rec["peak_terms"][:6]}
    out = {"cell": {"arch": args.arch, "reduced": args.reduced, "mesh": dict(zip(axes, sizes)),
                    "seq": shape.seq_len, "batch": shape.global_batch, "overrides": overrides},
           "xla": xla, "port": port,
           "flops_scan_once_vs_xla": port["flops_scan_once"] / xla["flops"] - 1,
           "temp_vs_xla": port["temp"] / xla["temp"] - 1}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
