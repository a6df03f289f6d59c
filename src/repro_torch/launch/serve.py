"""Serve launcher: the continuous-batching engine over a seeded random
model, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b --reduced \\
        --device cpu --requests 6 --slots 2 --gen 8 --temperature 0.7 --top-k 40

The flags are ``repro.launch.serve``'s plus ``--device``; ``--draft-k K``
turns on speculative decoding with a ``--draft-layers``-layer draft that
shares the target's weights.
"""
from __future__ import annotations

import argparse
import collections
import time

import numpy as np

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import init_params
from repro_torch.serving import ServeEngine, shrunken_draft


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--deadline", type=float, default=None,
        help="per-request deadline in seconds; expired requests are shed "
        "from the queue or cancelled mid-decode (KV blocks freed)",
    )
    ap.add_argument(
        "--max-batch", type=int, default=None,
        help="cap on concurrently decoding sequences (default: all slots)",
    )
    ap.add_argument(
        "--admit-max-wait", type=float, default=0.0,
        help="batching window in seconds: hold admissions so near-"
        "simultaneous arrivals join the decode batch together",
    )
    ap.add_argument(
        "--draft-k", type=int, default=0,
        help="speculative decoding draft depth (0 = off); the draft model "
        "is a --draft-layers-layer truncation of the target's own weights",
    )
    ap.add_argument(
        "--draft-layers", type=int, default=1,
        help="number of target layers kept in the shrunken draft model",
    )
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    params = init_params(cfg, 0, device=args.device)
    rng = np.random.default_rng(0)

    draft_cfg = draft_params = None
    if args.draft_k > 0:
        draft_cfg, draft_params = shrunken_draft(cfg, params, n_layers=args.draft_layers)

    with ServeEngine(
        cfg,
        params,
        n_slots=args.slots,
        max_seq=args.max_seq,
        block_size=args.block_size,
        max_batch=args.max_batch,
        admit_max_wait=args.admit_max_wait,
        draft_cfg=draft_cfg,
        draft_params=draft_params,
        draft_k=max(args.draft_k, 1),
        device=args.device,
    ) as eng:
        t0 = time.perf_counter()
        reqs = [
            eng.submit(
                rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32),
                args.gen,
                temperature=args.temperature,
                top_k=args.top_k,
                seed=args.seed + i,
                deadline=args.deadline,
            )
            for i in range(args.requests)
        ]
        eng.run_until_drained()
        dt = time.perf_counter() - t0
        total_toks = sum(len(r.out_tokens) for r in reqs)
        stats = eng.stats()
        pool = stats["pool"]
        print(
            f"[serve] {args.requests} requests × {args.gen} tokens on "
            f"{args.slots} slots ({eng.device}): {total_toks} tokens in {dt * 1e3:.0f}ms "
            f"({total_toks / dt:.0f} tok/s), {stats['steps']} engine iterations"
        )
        print(
            f"[serve] admissions: {stats['admitted']} admitted, "
            f"{stats['prefills']} prefills, {stats['restores']} restores, "
            f"{stats['preemptions']} preemptions; pool "
            f"{pool['live_blocks']}/{pool['n_blocks']} blocks live, "
            f"{pool['shared_hits']} shared hits, {pool['evictions']} evictions"
        )
        if "spec" in stats:
            sp = stats["spec"]
            print(
                f"[serve] speculation: k={sp['draft_k']}, {sp['rounds']} rounds "
                f"({sp['rollback_rounds']} rolled back, {sp['sheds']} shed), "
                f"accept rate {sp['accept_rate']:.2f}, "
                f"{sp['accepted_per_round']:.2f} tokens/round committed"
            )
        reject_reasons = collections.Counter(r.reject_reason for r in reqs if r.rejected)
        print(
            f"[serve] rejections: {sum(reject_reasons.values())} total "
            f"({reject_reasons['queue_full']} queue_full, "
            f"{reject_reasons['shed']} shed, "
            f"{reject_reasons['deadline']} deadline), "
            f"{stats['cancels']} mid-decode cancels"
        )
        if not all(r.done for r in reqs):
            raise RuntimeError("serve loop drained with unfinished requests")
        return {
            "tok_per_s": total_toks / dt,
            "evictions": pool["evictions"],
            "reject_reasons": dict(reject_reasons),
            "stats": stats,
        }


if __name__ == "__main__":
    main()
