"""Heterogeneous blocked GEMM (paper §4.3 + Fig. 2): one codelet, two
implementation variants — ``ref`` (the block product on the host) and
``cuda`` (the block product on the card, operands copied there and the
product copied back) — on a mixed team of 3 host workers and 1 card worker,
with the scheduler free to pick per worker kind.  Prints which kind ran how
many tasks and the error against A @ B, and exports the graph and trace::

    PYTHONPATH=src python -m repro_torch.examples.heterogeneous_gemm [--device cpu] [--n 256 --block 64]

With ``--device cpu`` the ``cuda`` variant is not available and the card
worker falls back to ``ref``.  ``main(argv)`` returns what the output shows.
"""
from __future__ import annotations

import argparse
import collections
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import SpData, SpRuntime, SpWorkerTeamBuilder, sp_task
from repro_torch.kernels.dispatch import resolve_device


def make_gemm(dev: torch.device, ran: collections.Counter):
    """The ``gemm`` codelet: C += A·B on a commutative C block.  ``ran``
    counts the tasks each variant ran."""
    lock = threading.Lock()

    def count(kind: str) -> None:
        with lock:
            ran[kind] += 1

    @sp_task(read=("a", "b"), commutative=("c",), name="gemm")
    def gemm_block(a, b, c):
        c.value = c.value + a @ b
        count("ref")

    @gemm_block.impl("cuda", available=lambda: dev.type == "cuda")
    def _gemm_block_cuda(a, b, c):
        prod = torch.matmul(a.to(dev, non_blocking=True), b.to(dev, non_blocking=True))
        c.value = c.value + prod.cpu()  # waits for the product on this worker's stream
        count("cuda")

    return gemm_block


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--block", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=None, help="where the graph and trace go (default: a new temporary directory)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, block = args.n, args.block
    nb = n // block
    rng = np.random.default_rng(args.seed)
    A = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))

    a = [[SpData(A[i * block:(i + 1) * block, k * block:(k + 1) * block]) for k in range(nb)] for i in range(nb)]
    b = [[SpData(B[k * block:(k + 1) * block, j * block:(j + 1) * block]) for j in range(nb)] for k in range(nb)]
    c = [[SpData(torch.zeros((block, block))) for _ in range(nb)] for _ in range(nb)]

    ran: collections.Counter = collections.Counter()
    gemm_block = make_gemm(dev, ran)
    team = SpWorkerTeamBuilder.team_of_cpu_cuda_workers(3, 1)  # 3 host + 1 card worker
    out_dir = Path(args.out_dir or tempfile.mkdtemp(prefix="hetero-gemm-"))
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with SpRuntime(backend="eager", workers=team) as rt:
        for i in range(nb):
            for j in range(nb):
                for k in range(nb):
                    gemm_block(
                        a[i][k], b[k][j], c[i][j], name=f"gemm[{i},{j},{k}]"
                    ).set_task_name(f"C{i}{j}+=A{i}{k}B{k}{j}")
        rt.wait_all_tasks()
        wall = time.perf_counter() - t0
        C = torch.cat([torch.cat([c[i][j].value for j in range(nb)], dim=1) for i in range(nb)], dim=0)
        err = float((C.double() - A.double() @ B.double()).abs().max())
        dot, trace = out_dir / "hetero_gemm.dot", out_dir / "hetero_gemm_trace.svg"
        rt.graph.generate_dot(str(dot))
        rt.graph.generate_trace(str(trace))
    by_kind = dict(ran)
    print(f"[gemm] {nb ** 3} tasks in {wall * 1e3:.0f}ms on {dev}: {by_kind}, max err {err:.2e}")
    print(f"[gemm] exported {dot}, {trace}")
    assert sum(by_kind.values()) == nb ** 3 and err < 1e-3, (by_kind, err)
    return {"tasks": nb ** 3, "by_kind": by_kind, "max_err": err, "wall_ms": wall * 1e3,
            "exported": [str(dot), str(trace)]}


if __name__ == "__main__":
    main()
