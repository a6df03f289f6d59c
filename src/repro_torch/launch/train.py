"""Train launcher: the staged train step on one card (or the CPU), over
seeded random weights and the synthetic data stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b --reduced \\
        --device cpu --steps 30 --batch 8 --seq 32 --microbatches 2 --log-every 5

The flags are ``repro.launch.train``'s single-device ones plus ``--device``
and ``--optimizer``.  Checkpointing (``--ckpt-dir``, ``--ckpt-every``,
``--resume``: ROADMAP.md Queue 1 item 3) and the elastic fault path
(``--fail-at``, ``--recovery``, ``--bench-out``: Queue 1 item 5) are not
ported yet and raise.  ``main(argv)`` returns ``{"losses", "final_step"}``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.data import Prefetcher, SyntheticLMDataset
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import linear_warmup_cosine
from repro_torch.runtime.train import build_train_step, init_train_state

_NOT_PORTED = {
    "ckpt_dir": 3, "ckpt_every": 3, "resume": 3,
    "fail_at": 5, "recovery": 5, "bench_out": 5,
}


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
    for flag in ("--ckpt-dir", "--ckpt-every", "--fail-at", "--recovery", "--bench-out"):
        ap.add_argument(flag, default=None, help="not ported yet: raises")
    ap.add_argument("--resume", action="store_true", help="not ported yet: raises")
    args = ap.parse_args(argv)
    for name, item in _NOT_PORTED.items():
        if getattr(args, name) not in (None, False):
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is not ported yet (ROADMAP.md, Queue 1 item {item})"
            )

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.optimizer:
        cfg = cfg.replace(optimizer=args.optimizer)
    state = init_train_state(cfg, args.seed, device=args.device)
    dev = state.step.device
    art = build_train_step(
        cfg, n_microbatches=args.microbatches, schedule_policy=args.schedule_policy,
        lr_schedule=linear_warmup_cosine(args.lr, warmup=10, total_steps=args.steps),
    )
    ds = SyntheticLMDataset(cfg, ShapeSpec("train", "train", args.seq, args.batch), seed=0)
    pf = Prefetcher(ds, start_step=0, depth=2)
    losses: list[float] = []
    t0 = time.perf_counter()
    try:
        for _ in range(args.steps):
            _, batch = pf.get()
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            state, metrics = art(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            s = int(state.step)
            if args.log_every and s % args.log_every == 0:
                dt = (time.perf_counter() - t0) / len(losses)
                print(f"[train] step {s:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f} {dt * 1e3:7.1f} ms/step",
                      flush=True)
    finally:
        pf.stop()
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"losses": losses, "final_step": int(state.step)}


if __name__ == "__main__":
    main()
