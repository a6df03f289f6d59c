"""Train launcher: the staged train step on one card (or the CPU), over
seeded random weights and the synthetic data stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b --reduced \\
        --device cpu --steps 30 --batch 8 --seq 32 --microbatches 2 --log-every 5 \\
        --ckpt-dir ck --ckpt-every 10          # later: the same with --resume

The flags are ``repro.launch.train``'s plus ``--device`` and
``--optimizer``.  ``--ckpt-every N`` saves the state every N steps into
``--ckpt-dir`` (async commit); ``--resume`` restores the newest step there
and restarts the data stream at it.

The loop is a plain ``SpRuntime(workers=1, elastic=True).elastic_loop``
with no recovery control flow of its own: ``--fail-at STEP:RANKS`` injects
a rank loss at STEP through a :class:`~repro_torch.dist.fault.FailureSimulator`,
and the runtime catches the ``SpRankDeadError`` and calls
:func:`train_loop`'s ``on_reshard`` hook (``--recovery live``: continue
from the in-memory state; ``restore``: the latest checkpoint this run
saved).  The CLI trains on one card and has no mesh to shrink, so — as
``repro`` does with one device — an injected failure prints "failure
injected but only one device; continuing" and the run goes on.
:func:`train_loop` run by every rank of a real mesh (under ``use_mesh``,
the group joined through ``launch.mesh.spawn_mesh``) re-meshes instead:
``remesh_plan(ranks, lost, model_parallel=m)`` keeps the ``model`` axis and
shrinks the data axes, the ranks past the plan leave
(``launch.mesh.shrink_mesh``), and the survivors restore the last
checkpoint this loop saved onto the new mesh, whatever ``--recovery``
says, and resume from the step they agree on.
``--bench-out PATH`` writes ``{"recoveries": [...], "final_step": N}``.
``main(argv)`` returns ``{"losses", "final_step"}``;
``losses[i]`` is the loss of step ``start + i + 1``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import SpRankDeadError, SpRuntime
from repro_torch.data import Prefetcher, SyntheticLMDataset
from repro_torch.dist.fault import FailureSimulator, remesh_plan
from repro_torch.dist.sharding import current_mesh, mesh_shape, use_mesh
from repro_torch.models import Transformer
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import TrainState, linear_warmup_cosine
from repro_torch.runtime.train import build_train_step, init_train_state


class LeftMesh(Exception):
    """Raised inside :func:`train_loop` on a rank the re-mesh leaves out."""


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _parse_fail_at(spec: str) -> FailureSimulator:
    try:
        step_s, ranks_s = spec.split(":")
        step, ranks = int(step_s), int(ranks_s)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected STEP:RANKS integers, got {spec!r}")
    if step < 1:
        raise argparse.ArgumentTypeError("STEP must be >= 1 (checked after each step)")
    if ranks < 1:
        raise argparse.ArgumentTypeError("RANKS must be >= 1")
    return FailureSimulator({step: ranks})


def train_loop(cfg, state, *, steps: int, batch: int, seq: int, microbatches: int,
               lr: float = 1e-3, schedule_policy: str = "overlap", start_step: int = 0,
               mgr: CheckpointManager | None = None, ckpt_every: int = 0,
               log_every: int = 0, sim: FailureSimulator | None = None,
               recovery: str = "live", recoveries: list | None = None) -> tuple:
    """Train ``state`` from ``start_step`` to ``steps`` over the synthetic
    stream (restarted at ``start_step``) under an elastic runtime, saving
    into ``mgr`` every ``ckpt_every`` steps (async commit) and waiting for
    the last commit before returning → (state, losses).  ``sim`` injects
    rank losses; each recovery the ``on_reshard`` hook makes is appended to
    ``recoveries`` as ``{"mode", "step", "seconds"}`` (on a real mesh also
    ``"mesh"``, the new mesh's shape).  Called by every rank of a mesh
    (under its ``use_mesh``) the step is sharded as ``build_train_step``
    shards it and a rank loss re-meshes (module docstring); a rank the
    re-mesh leaves out returns (None, its losses so far)."""
    def make_step():
        return build_train_step(
            cfg, n_microbatches=microbatches, schedule_policy=schedule_policy,
            lr_schedule=linear_warmup_cosine(lr, warmup=10, total_steps=steps),
        )

    ds = SyntheticLMDataset(cfg, ShapeSpec("train", "train", seq, batch), seed=0)
    dev = state.step.device
    losses: list[float] = []  # losses[i] is the loss of step base + i + 1
    # segment state shared by the step function and the reshard hook; only
    # checkpoints this loop saved may be restored after a failure
    st = {"state": state, "pf": Prefetcher(ds, start_step=start_step, depth=2), "art": make_step(),
          "mesh": current_mesh(), "lost": 0,
          "base": start_step, "restorable": False, "t0": time.perf_counter(), "n": 0}

    def on_mesh():
        return use_mesh(st["mesh"]) if st["mesh"] is not None else contextlib.nullcontext()

    def train_step(step: int) -> float:
        """One step, no failure handling: an injected rank loss raises
        SpRankDeadError and the elastic runtime calls ``on_reshard``."""
        with on_mesh():
            return _step()

    def _step() -> float:
        _, b = st["pf"].get()
        st["state"], metrics = st["art"](st["state"], {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        loss = float(metrics["loss"])
        losses.append(loss)
        st["n"] += 1
        s = int(st["state"].step)
        if log_every and s % log_every == 0:
            dt = (time.perf_counter() - st["t0"]) / st["n"]
            aux = "".join(f" {k} {float(metrics[k]):.4f}" for k in ("moe_balance", "moe_zloss")
                          if k in metrics)
            print(f"[train] step {s:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f}{aux} {dt * 1e3:7.1f} ms/step",
                  flush=True)
        if mgr is not None and ckpt_every and s % ckpt_every == 0:
            mgr.save(s, st["state"])  # async commit
            st["restorable"] = True
        lost = sim.check(s) if sim is not None else 0
        if lost and (st["mesh"] is None or _world() == 1):
            # one card, no mesh: nothing to shrink onto, so nothing is lost
            print("[train] failure injected but only one device; continuing", flush=True)
        elif lost:
            st["lost"] = lost
            raise SpRankDeadError(f"{lost} of {_world()} ranks lost after step {s}")
        return loss

    def remesh(event) -> int:
        """Shrink the mesh over the survivors (keeping its ``model`` axis),
        restore the last checkpoint onto it and agree on the resume step."""
        from repro_torch.launch.mesh import shrink_mesh
        import torch.distributed as dist

        if not st["restorable"]:
            raise RuntimeError("a re-mesh restores the last checkpoint this loop saved: pass mgr and ckpt_every")
        sizes = mesh_shape(st["mesh"])
        pod = math.prod(n for a, n in sizes.items() if a != "pod") if "pod" in sizes else None
        plan = remesh_plan(math.prod(sizes.values()), st["lost"], model_parallel=sizes.get("model", 1),
                           pod_size=pod)
        st["lost"] = 0
        mgr.wait()
        st["state"] = None
        mesh = shrink_mesh(plan.n_chips, plan.shape, plan.axes, tag=f"remesh-{event.epoch}")
        if mesh is None:
            raise LeftMesh(f"left the mesh after a loss of ranks: re-meshed to {plan.shape}")
        st["mesh"] = mesh
        print(f"[train] lost ranks: re-meshed to {dict(zip(plan.axes, plan.shape))} "
              f"({plan.dropped_chips} chips dropped)", flush=True)
        with on_mesh():
            template = TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                                  params=Transformer(cfg, device="meta"), opt=None)
            resume, st["state"] = mgr.restore(template)
            agreed = torch.tensor([resume], dtype=torch.int64, device=dev)
            dist.all_reduce(agreed, op=dist.ReduceOp.MIN)
            if int(agreed) != resume:
                raise RuntimeError(f"ranks disagree on the resume step: {resume} here, {int(agreed)} agreed")
            st["art"] = make_step()
        print(f"[train] restored step {resume} onto the new mesh", flush=True)
        return resume

    def on_reshard(event) -> int:
        """Domain half of a recovery: on a real mesh :func:`remesh`; on one
        device keep the in-memory state (``live``) or restore the latest
        checkpoint this loop saved (``restore``); then restart the data
        stream at the resume step."""
        t_rec = time.perf_counter()
        if st["lost"]:
            resume, mode = remesh(event), "restore"
            del losses[max(resume - st["base"], 0):]
        elif recovery == "restore" and st["restorable"]:
            mgr.wait()  # the last save's commit may still be running
            resume, st["state"] = mgr.restore(st["state"])
            del losses[max(resume - st["base"], 0):]
            mode = "restore"
        else:
            resume, mode = int(st["state"].step), "live"
        st["pf"].stop()
        st["pf"] = Prefetcher(ds, start_step=resume, depth=2)
        if recoveries is not None:
            rec = {"mode": mode, "step": resume, "seconds": time.perf_counter() - t_rec}
            if st["mesh"] is not None:
                rec["mesh"] = mesh_shape(st["mesh"])
            recoveries.append(rec)
        return resume

    try:
        if start_step < steps:
            with SpRuntime(workers=1, elastic=True, on_reshard=on_reshard) as rt:
                rt.elastic_loop(train_step, steps, start=start_step)
    except LeftMesh:
        pass
    finally:
        st["pf"].stop()
        if mgr is not None:
            mgr.wait()
    return st["state"], losses


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", choices=("adamw", "adafactor"), default=None,
                    help="default: the config's")
    ap.add_argument("--schedule-policy", default="overlap")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument(
        "--fail-at", default=None, metavar="STEP:RANKS", type=_parse_fail_at,
        help="simulate losing RANKS chips at STEP (one card: logged, the run goes on)",
    )
    ap.add_argument(
        "--recovery", choices=("live", "restore"), default="live",
        help="after a loss: keep the in-memory state (default) or restore the latest checkpoint",
    )
    ap.add_argument("--bench-out", default=None, metavar="PATH",
                    help="write recovery timings as JSON to PATH")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.optimizer:
        cfg = cfg.replace(optimizer=args.optimizer)
    mgr = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    state = init_train_state(cfg, args.seed, device=args.device)
    start_step = 0
    if mgr is not None and args.resume and mgr.latest_step() is not None:
        start_step, state = mgr.restore(state)
        print(f"[train] resumed from step {start_step}")
    recoveries: list[dict] = []
    state, losses = train_loop(
        cfg, state, steps=args.steps, batch=args.batch, seq=args.seq,
        microbatches=args.microbatches, lr=args.lr, schedule_policy=args.schedule_policy,
        start_step=start_step, mgr=mgr, ckpt_every=args.ckpt_every, log_every=args.log_every,
        sim=args.fail_at, recovery=args.recovery, recoveries=recoveries,
    )
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print("[train] nothing to do: start step >= --steps")
    final_step = int(state.step)
    if args.bench_out:
        with open(args.bench_out, "w") as f:
            json.dump({"recoveries": recoveries, "final_step": final_step}, f, indent=2)
        print(f"[train] wrote recovery timings to {args.bench_out}")
    return {"losses": losses, "final_step": final_step}


if __name__ == "__main__":
    main()
