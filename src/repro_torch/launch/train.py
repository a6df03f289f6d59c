"""Train launcher: the staged train step on one card (or the CPU), over
seeded random weights and the synthetic data stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b --reduced \\
        --device cpu --steps 30 --batch 8 --seq 32 --microbatches 2 --log-every 5 \\
        --ckpt-dir ck --ckpt-every 10          # later: the same with --resume

The flags are ``repro.launch.train``'s single-device ones plus ``--device``
and ``--optimizer``.  ``--ckpt-every N`` saves the state every N steps
into ``--ckpt-dir`` (async commit); ``--resume`` restores the newest step
there and restarts the data stream at it.  The elastic fault path
(``--fail-at``, ``--recovery``, ``--bench-out``: ROADMAP.md Queue 1 item 5)
is not ported yet and raises.  ``main(argv)`` returns ``{"losses",
"final_step"}``; ``losses[i]`` is the loss of step ``start + i + 1``.
:func:`train_loop` is the loop itself, for callers that build the state.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import Prefetcher, SyntheticLMDataset
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import linear_warmup_cosine
from repro_torch.runtime.train import build_train_step, init_train_state

_NOT_PORTED = ("fail_at", "recovery", "bench_out")  # ROADMAP.md Queue 1 item 5


def train_loop(cfg, state, *, steps: int, batch: int, seq: int, microbatches: int,
               lr: float = 1e-3, schedule_policy: str = "overlap", start_step: int = 0,
               mgr: CheckpointManager | None = None, ckpt_every: int = 0,
               log_every: int = 0) -> tuple:
    """Train ``state`` from ``start_step`` to ``steps`` over the synthetic
    stream (restarted at ``start_step``), saving into ``mgr`` every
    ``ckpt_every`` steps (async commit) and waiting for the last commit
    before returning → (state, losses)."""
    art = build_train_step(
        cfg, n_microbatches=microbatches, schedule_policy=schedule_policy,
        lr_schedule=linear_warmup_cosine(lr, warmup=10, total_steps=steps),
    )
    ds = SyntheticLMDataset(cfg, ShapeSpec("train", "train", seq, batch), seed=0)
    pf = Prefetcher(ds, start_step=start_step, depth=2)
    dev = state.step.device
    losses: list[float] = []
    t0 = time.perf_counter()
    try:
        for _ in range(start_step, steps):
            _, b = pf.get()
            state, metrics = art(state, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
            loss = float(metrics["loss"])
            losses.append(loss)
            s = int(state.step)
            if log_every and s % log_every == 0:
                dt = (time.perf_counter() - t0) / len(losses)
                print(f"[train] step {s:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f} {dt * 1e3:7.1f} ms/step",
                      flush=True)
            if mgr is not None and ckpt_every and s % ckpt_every == 0:
                mgr.save(s, state)  # async commit
    finally:
        pf.stop()
        if mgr is not None:
            mgr.wait()
    return state, losses


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
    for flag in ("--fail-at", "--recovery", "--bench-out"):
        ap.add_argument(flag, default=None, help="not ported yet: raises")
    args = ap.parse_args(argv)
    for name in _NOT_PORTED:
        if getattr(args, name) is not None:
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is not ported yet (ROADMAP.md, Queue 1 item 5)"
            )

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.optimizer:
        cfg = cfg.replace(optimizer=args.optimizer)
    mgr = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    state = init_train_state(cfg, args.seed, device=args.device)
    start_step = 0
    if mgr is not None and args.resume and mgr.latest_step() is not None:
        start_step, state = mgr.restore(state)
        print(f"[train] resumed from step {start_step}")
    state, losses = train_loop(
        cfg, state, steps=args.steps, batch=args.batch, seq=args.seq,
        microbatches=args.microbatches, lr=args.lr, schedule_policy=args.schedule_policy,
        start_step=start_step, mgr=mgr, ckpt_every=args.ckpt_every, log_every=args.log_every,
    )
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print("[train] nothing to do: start step >= --steps")
    return {"losses": losses, "final_step": int(state.step)}


if __name__ == "__main__":
    main()
