"""Production mesh construction on ``torch.distributed`` — the port of
``repro.launch.mesh``.

Functions, not module constants, so importing touches no process group.
Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2, data=16,
model=16) = 512; the ``pod`` axis is pure data parallelism over the slow
inter-pod links, which the sharding rules use only for the batch axis and
the hierarchical gradient reduction (``dist.collectives.hierarchical_psum``).

The caller initialises the default process group first
(``torch.distributed.init_process_group``, one rank a card under NCCL, or
CPU processes under gloo).  The mesh's device type follows the backend:
``"cuda"`` under NCCL, ``"cpu"`` under gloo.

:func:`spawn_mesh` starts one process a rank on this host, joins them in a
process group over ``tcp://localhost:<free port>``, builds the mesh and
runs a function in each rank under ``use_mesh``.  The CLI runs the
data-parallel train step that way and holds every rank's parameters
against one process's step on the same global batch::

    python -m repro_torch.launch.mesh --ranks 2 --device cpu        # gloo
    python -m repro_torch.launch.mesh --ranks 4 --pods 2 --device cpu
    python -m repro_torch.launch.mesh --ranks 1                     # NCCL, one card
"""
from __future__ import annotations

import argparse
import functools
import math
import multiprocessing as mp
import socket
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.sharding import use_mesh

SINGLE_POD = (16, 16)
SINGLE_POD_AXES = ("data", "model")
MULTI_POD = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs the default process group: call "
            "torch.distributed.init_process_group first"
        )
    return dist.get_world_size()


def mesh_device_type() -> str:
    """``"cuda"`` when the default group runs NCCL, else ``"cpu"``."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """The 256- or 512-rank mesh; raises unless the world is exactly that."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = MULTI_POD_AXES if multi_pod else SINGLE_POD_AXES
    world = _world_size()
    if world != math.prod(shape):
        raise RuntimeError(
            f"the {'multi' if multi_pod else 'single'}-pod mesh {dict(zip(axes, shape))} needs "
            f"{math.prod(shape)} ranks; the process group has {world}"
        )
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(model_parallel: int | None = None):
    """A small (data, model) mesh over the process group's ranks (tests,
    examples): ``model`` is 2 when the world is even and larger than 1."""
    from torch.distributed.device_mesh import init_device_mesh

    n = _world_size()
    n_model = model_parallel or (2 if n % 2 == 0 and n > 1 else 1)
    if n % n_model:
        raise ValueError(f"model_parallel {n_model} does not divide the world size {n}")
    return init_device_mesh(mesh_device_type(), (n // n_model, n_model), mesh_dim_names=("data", "model"))


# ---------------------------------------------------------------------------
# Rank processes on one host.
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A TCP port the OS reports free on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_group(rank: int, size: int, port: int, backend: str) -> None:
    """Join the default process group at ``tcp://localhost:port``."""
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=size, rank=rank)


def _mesh_rank(rank, size, port, backend, shape, axes, fn, args, q) -> None:
    try:
        from torch.distributed.device_mesh import init_device_mesh

        init_group(rank, size, port, backend)
        try:
            mesh = init_device_mesh(mesh_device_type(), tuple(shape), mesh_dim_names=tuple(axes))
            with use_mesh(mesh):
                out = fn(*args)
        finally:
            dist.destroy_process_group()
        q.put((rank, ("ok", out)))
    except BaseException as e:  # reported to the parent, which raises
        q.put((rank, ("error", f"{type(e).__name__}: {e}")))
        raise


def spawn_mesh(fn: Callable, size: int, shape: Sequence[int], axes: Sequence[str], *args,
               backend: str = "gloo", timeout: float = 120.0) -> list:
    """Spawn ``size`` rank processes, build a ``shape`` mesh named ``axes``
    over their process group and return ``fn(*args)`` of every rank, in rank
    order (``fn`` runs under ``use_mesh``; it — a module-level function or a
    ``functools.partial`` of one — and its result are pickled).
    Raises when a rank fails or the ranks do not report within
    ``timeout``; every process is reaped."""
    from repro_torch.launch.rendezvous import _collect, _reap

    ctx = mp.get_context("spawn")
    q: Any = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_mesh_rank, daemon=True,
                         args=(r, size, port, backend, tuple(shape), tuple(axes), fn, args, q))
             for r in range(size)]
    for p in procs:
        p.start()
    try:
        got = _collect(procs, q, size, time.monotonic() + timeout)
    finally:
        _reap(procs)
    errors = {r: v for r, (kind, v) in got.items() if kind == "error"}
    if errors:
        raise RuntimeError(f"rank processes failed: {errors}")
    return [got[r][1] for r in range(size)]


# ---------------------------------------------------------------------------
# The data-parallel train step, run from the CLI.
# ---------------------------------------------------------------------------

DP_STEPS, DP_BATCH, DP_SEQ = 2, 4, 16


def dp_train(device="cuda") -> dict:
    """``DP_STEPS`` train steps of reduced deepseek-7b (fp32, one
    microbatch) from the state seeded with 0, each on the same seeded
    global batch of (``DP_BATCH``, ``DP_SEQ``) on every rank: data-parallel
    under an active mesh, one process off it.
    → {"losses", "grad_norms" (each step's, after the ranks' mean),
    "params" (name → numpy)}."""
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.runtime.train import build_train_step, init_train_state

    device = resolve_device(device)
    cfg = reduced_config("deepseek-7b").replace(dtype="float32")
    state = init_train_state(cfg, 0, device=device)
    art = build_train_step(cfg)
    gen = torch.Generator().manual_seed(1)
    losses, grad_norms = [], []
    for _ in range(DP_STEPS):
        tokens = torch.randint(0, cfg.vocab, (DP_BATCH, DP_SEQ + 1), generator=gen, dtype=torch.int32)
        b = {"tokens": tokens[:, :-1].to(device), "labels": tokens[:, 1:].to(device)}
        state, metrics = art(state, b)
        losses.append(float(metrics["loss"]))
        grad_norms.append(float(metrics["grad_norm"]))
    params = {n: p.detach().float().cpu().numpy() for n, p in state.params.named_parameters()}
    return {"losses": losses, "grad_norms": grad_norms, "params": params}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="the data-parallel train step over spawned rank processes")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--pods", type=int, default=1, help="a 'pod' axis of this size (pod x data)")
    ap.add_argument("--device", default="cuda", help="'cuda' (NCCL, one card a rank) or 'cpu' (gloo)")
    args = ap.parse_args(argv)

    from repro_torch.kernels.dispatch import resolve_device

    device = resolve_device(args.device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if args.ranks % args.pods:
        raise ValueError(f"--pods {args.pods} does not divide --ranks {args.ranks}")
    shape, axes = ((args.pods, args.ranks // args.pods), ("pod", "data")) if args.pods > 1 \
        else ((args.ranks,), ("data",))
    t0 = time.perf_counter()
    ranks = spawn_mesh(functools.partial(dp_train, str(device)), args.ranks, shape, axes, backend=backend,
                       timeout=600.0)
    wall = time.perf_counter() - t0
    one = dp_train(str(device))
    worst = max(float(np.abs(r["params"][n] - one["params"][n]).max())
                for r in ranks for n in one["params"])
    same = all(np.array_equal(r["params"][n], ranks[0]["params"][n]) for r in ranks for n in one["params"])
    print(f"[mesh] {args.ranks} ranks ({backend}, mesh {dict(zip(axes, shape))}): losses "
          f"{ranks[0]['losses']}, grad norms {ranks[0]['grad_norms']} in {wall:.1f} s with start-up; "
          f"one process: {one['losses']}, {one['grad_norms']}; "
          f"ranks' parameters equal: {same}; max |rank - one process| = {worst:.3e}")
    return {"ranks": ranks, "one": one, "max_diff": worst, "ranks_equal": same}


if __name__ == "__main__":
    main()
