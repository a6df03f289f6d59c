"""Serving example: fit a small model on the synthetic affine rule, then
serve a batch of prompts through the continuous-batching ``ServeEngine`` —
paged KV cache, prefix sharing (one request duplicates a prompt and shares
its blocks), and per-request sampling controls::

    PYTHONPATH=src python -m repro_torch.examples.serve_lm
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --temperature 0.8 --top-k 20 --seed 7

With ``--draft K`` the same batch is served a second time with speculative
decoding (a 1-layer truncation of the fitted model drafts K tokens a round,
the full model verifies them through the runtime's commit/rollback
speculation machinery), and the demo asserts that the committed greedy
output equals the plain engine's::

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --draft 4

``--device cpu`` runs it on the host.  ``main(argv)`` returns what the
output shows.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.data import SyntheticLMDataset
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.config import ArchConfig, ShapeSpec
from repro_torch.optim import constant_schedule
from repro_torch.runtime.train import build_train_step, init_train_state
from repro_torch.serving import ServeEngine, shrunken_draft

CFG = ArchConfig(
    name="serve-demo", family="dense", n_layers=4, d_model=192, n_heads=6,
    n_kv_heads=3, head_dim=32, d_ff=768, vocab=512, act="swiglu",
    attn_blockwise_min_seq=512,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fit-steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; >0 samples from the scaled distribution")
    ap.add_argument("--top-k", type=int, default=0, help="0 = no top-k filter")
    ap.add_argument("--seed", type=int, default=0, help="per-request sampling seed base")
    ap.add_argument("--draft", type=int, default=0, metavar="K",
                    help="re-serve the batch with speculative decoding at "
                    "draft depth K and assert the same committed output")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    shape = ShapeSpec("t", "train", 64, args.batch)
    ds = SyntheticLMDataset(CFG, shape, seed=0)

    # quick fit so generation is meaningful
    state = init_train_state(CFG, 0, device=dev)
    art = build_train_step(CFG, lr_schedule=constant_schedule(3e-3))
    for i in range(args.fit_steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch_for_step(i).items()}
        state, m = art(state, batch)
    fit_loss = float(m["loss"]) if args.fit_steps else float("nan")
    print(f"[serve] fitted {args.fit_steps} steps, loss={fit_loss:.3f}")
    shown = {"fit_loss": fit_loss}

    # ---- serve the prompts through the continuous-batching engine ---------
    eval_batch = ds.batch_for_step(10_000)
    prompts = np.asarray(eval_batch["tokens"][:, : args.prompt], np.int32)
    gold = np.asarray(eval_batch["tokens"][:, args.prompt : args.prompt + args.gen])
    sample = dict(temperature=args.temperature, top_k=args.top_k)

    with ServeEngine(CFG, state.params, n_slots=args.batch + 1, max_seq=args.prompt + args.gen,
                     block_size=4, device=dev) as eng:
        t0 = time.perf_counter()
        reqs = [eng.submit(prompts[i], args.gen, seed=args.seed + i, **sample) for i in range(args.batch)]
        # a duplicate of prompt 0: its KV blocks are shared, not recomputed
        dup = eng.submit(prompts[0], args.gen, seed=args.seed, **sample)
        eng.run_until_drained()
        dt = time.perf_counter() - t0

        out = np.stack([r.out_tokens for r in reqs])
        acc = float((out == gold).mean())
        stats = eng.stats()
        pool = stats["pool"]
        toks = sum(len(r.out_tokens) for r in reqs) + len(dup.out_tokens)
        print(
            f"[serve] {args.batch}+1 requests × {args.gen} tokens in "
            f"{dt * 1e3:.0f}ms ({toks / dt:.0f} tok/s), "
            f"{stats['steps']} engine iterations, {stats['prefills']} prefills"
        )
        print(
            f"[serve] paged pool: {pool['live_blocks']}/{pool['n_blocks']} blocks, "
            f"{pool['shared_hits']} shared-block hits, {pool['cow_copies']} COW copies"
        )
        print(f"[serve] continuation accuracy vs rule: {acc:.2%}")
        assert pool["shared_hits"] > 0, "duplicate prompt should share KV blocks"
        if args.temperature == 0.0:
            assert dup.out_tokens == reqs[0].out_tokens, "greedy decode of a shared prompt must match"
            assert acc > 0.5, "a fitted model should continue the affine rule"
        plain_out = [list(r.out_tokens) for r in reqs]
        shown.update(accuracy=acc, tokens=toks, tok_per_s=toks / dt, shared_hits=pool["shared_hits"],
                     out=plain_out, dup=list(dup.out_tokens))

    if args.draft > 0:
        # ---- same batch again, speculatively: draft = 1-layer truncation --
        draft_cfg, draft_params = shrunken_draft(CFG, state.params, n_layers=1)
        with ServeEngine(CFG, state.params, n_slots=args.batch, max_seq=args.prompt + args.gen,
                         block_size=4, draft_cfg=draft_cfg, draft_params=draft_params,
                         draft_k=args.draft, device=dev) as eng:
            t0 = time.perf_counter()
            reqs = [eng.submit(prompts[i], args.gen, seed=args.seed + i, speculative=True, **sample)
                    for i in range(args.batch)]
            eng.run_until_drained()
            dt_spec = time.perf_counter() - t0
            sp = eng.stats()["spec"]
            print(
                f"[serve] speculative (k={args.draft}): {dt_spec * 1e3:.0f}ms, "
                f"{sp['rounds']} rounds, accept rate {sp['accept_rate']:.2f}, "
                f"{sp['accepted_per_round']:.2f} committed tokens/round, "
                f"{sp['graph']['commits']} graph commits / "
                f"{sp['graph']['rollbacks']} rollbacks"
            )
            spec_out = [list(r.out_tokens) for r in reqs]
            assert spec_out == plain_out, "speculative decode must equal the plain engine's"
            print("[serve] speculative output equal to plain decode")
            shown.update(spec_out=spec_out, accept_rate=sp["accept_rate"], rounds=sp["rounds"])
    return shown


if __name__ == "__main__":
    main()
