"""End-to-end training example: train a language model on the synthetic
affine-rule stream and watch the loss collapse.

The default preset is a ~10M-parameter llama-style model; ``--preset 100m``
selects the ~100M-parameter configuration (the same code path).  Dense
block kind, the staged train step (2 microbatches), ``SyntheticLMDataset``
through the prefetcher, and a ``CheckpointManager`` save every 50 steps::

    PYTHONPATH=src python -m repro_torch.examples.train_lm                 # ~10M, 60 steps
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu --steps 20 --seq 64

``main(argv)`` returns ``{"losses", "first", "last", "saved"}``.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import Prefetcher, SyntheticLMDataset
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.config import ArchConfig, ShapeSpec
from repro_torch.optim import linear_warmup_cosine
from repro_torch.runtime.train import build_train_step, init_train_state

PRESETS = {
    "10m": ArchConfig(
        name="lm-10m", family="dense", n_layers=6, d_model=256, n_heads=8,
        n_kv_heads=4, head_dim=32, d_ff=1024, vocab=8192, act="swiglu",
        attn_blockwise_min_seq=512,
    ),
    "100m": ArchConfig(
        name="lm-100m", family="dense", n_layers=10, d_model=640, n_heads=10,
        n_kv_heads=5, head_dim=64, d_ff=2560, vocab=32000, act="swiglu",
        attn_blockwise_min_seq=1024,
    ),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="10m", choices=sorted(PRESETS))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None, help="default: a new temporary directory")
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = PRESETS[args.preset]
    print(f"[lm] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params on {dev}")
    shape = ShapeSpec("train", "train", args.seq, args.batch)
    ds = SyntheticLMDataset(cfg, shape, seed=0)
    mgr = CheckpointManager(args.ckpt_dir or tempfile.mkdtemp(prefix="train-lm-"), keep=2)

    state = init_train_state(cfg, 0, device=dev)
    art = build_train_step(
        cfg,
        n_microbatches=2,
        lr_schedule=linear_warmup_cosine(args.lr, 10, args.steps),
    )
    pf = Prefetcher(ds, depth=2)
    losses: list[float] = []
    try:
        t0 = time.perf_counter()
        for i in range(args.steps):
            _, batch = pf.get()
            state, metrics = art(state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
            losses.append(float(metrics["loss"]))
            if (i + 1) % 10 == 0:
                dt = (time.perf_counter() - t0) / (i + 1)
                print(f"[lm] step {i + 1:4d}  loss {losses[-1]:7.4f}  {dt * 1e3:7.0f} ms/step", flush=True)
            if args.ckpt_every and (i + 1) % args.ckpt_every == 0:
                mgr.save(i + 1, state)
        mgr.wait()
    finally:
        pf.stop()
    print(f"[lm] loss {losses[0]:.4f} -> {losses[-1]:.4f} over {args.steps} steps")
    assert losses[-1] < losses[0], "training should reduce loss on the synthetic rule"
    return {"losses": losses, "first": losses[0], "last": losses[-1], "saved": mgr.all_steps()}


if __name__ == "__main__":
    main()
