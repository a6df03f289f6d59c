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
process group through a ``TCPStore`` the parent holds open on a port the OS
chose (so two groups started at once never meet at one port), builds the
mesh and runs a function in each rank under ``use_mesh``.
:func:`shrink_mesh` re-forms a smaller group and mesh over the first ranks
of such a group (the elastic re-mesh).  The CLI runs the data-parallel
train step (:func:`dp_train`) or, with ``--model N``, the tensor-parallel
one (:func:`tp_train`, a ``(ranks / N, N)`` data × model mesh) that way and
holds every rank's parameters (gathered whole by :func:`gather_params`)
against one process's step on the same global batch::

    python -m repro_torch.launch.mesh --ranks 2 --device cpu        # gloo
    python -m repro_torch.launch.mesh --ranks 4 --pods 2 --device cpu
    python -m repro_torch.launch.mesh --ranks 2 --model 2 --device cpu
    python -m repro_torch.launch.mesh --ranks 1                     # NCCL, one card
"""
from __future__ import annotations

import argparse
import datetime
import functools
import math
import multiprocessing as mp
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

#: the store this process joined its group through (:func:`join_group`);
#: :func:`shrink_mesh` forms the next group through it
_STORE: list = []


def join_group(rank: int, size: int, backend: str, port: int | None = None, timeout: float = 300.0) -> None:
    """Join the default process group through a ``TCPStore``: the one served
    at ``localhost:port`` (the parent's, :func:`spawn_mesh`) or, without a
    ``port``, one this process serves on a port the OS chose (a group of
    one, which nobody else has to find)."""
    td = datetime.timedelta(seconds=timeout)
    if port is None:
        if size != 1:
            raise ValueError(f"a group of {size} ranks joins through a store served at a known port")
        store = dist.TCPStore("localhost", 0, 1, is_master=True, wait_for_workers=False, timeout=td)
    else:
        store = dist.TCPStore("localhost", port, size, is_master=False, timeout=td)
    _STORE[:] = [store]
    dist.init_process_group(backend, store=store, world_size=size, rank=rank)


def shrink_mesh(n_keep: int, shape: Sequence[int], axes: Sequence[str], tag: str):
    """Leave the default group; the ranks below ``n_keep`` form a new one
    (keys under ``tag`` in the store they joined through) and return a
    ``shape`` mesh named ``axes`` over it, the others None.  Every rank of
    the old group calls it with the same arguments; a rank that died would
    simply not, as the survivors need nothing of it."""
    from torch.distributed.device_mesh import init_device_mesh

    if not _STORE:
        raise RuntimeError("shrink_mesh needs a group joined through launch.mesh.join_group (spawn_mesh)")
    rank, backend = dist.get_rank(), dist.get_backend()
    dist.destroy_process_group()
    if rank >= n_keep:
        return None
    dist.init_process_group(backend, store=dist.PrefixStore(tag, _STORE[0]), world_size=n_keep, rank=rank)
    return init_device_mesh(mesh_device_type(), tuple(shape), mesh_dim_names=tuple(axes))


def _mesh_rank(rank, size, port, backend, shape, axes, fn, args, q) -> None:
    try:
        from torch.distributed.device_mesh import init_device_mesh

        join_group(rank, size, backend, port)
        try:
            mesh = init_device_mesh(mesh_device_type(), tuple(shape), mesh_dim_names=tuple(axes))
            with use_mesh(mesh):
                out = fn(*args)
            if dist.is_initialized():  # (a rank that left in a re-mesh is not)
                dist.barrier()  # no rank tears its links down while a peer still uses them
        finally:
            if dist.is_initialized():
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
    # the parent serves the rendezvous store on a port the OS chose and holds
    # it until the ranks are reaped: no other group can take that port
    store = dist.TCPStore("localhost", 0, None, is_master=True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout))
    procs = [ctx.Process(target=_mesh_rank, daemon=True,
                         args=(r, size, store.port, backend, tuple(shape), tuple(axes), fn, args, q))
             for r in range(size)]
    for p in procs:
        p.start()
    try:
        got = _collect(procs, q, size, time.monotonic() + timeout)
    finally:
        _reap(procs)
        del store
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


# ---------------------------------------------------------------------------
# The tensor-parallel train step (a data x model mesh).
# ---------------------------------------------------------------------------

TP_STEPS, TP_BATCH, TP_SEQ = 2, 4, 16


#: :func:`tp_config`'s variants of another family: the reduced config of each arch
TP_FAMILIES = {"ssm": "mamba2-130m", "hybrid": "recurrentgemma-9b", "audio": "hubert-xlarge",
               "vision": "internvl2-2b"}


def tp_config(variant: str = "dense", optimizer: str = "adamw"):
    """Reduced deepseek-7b in fp32 with ``optimizer``; ``variant="gqa"``
    gives it 1 KV head (replicated over ``model``: each rank reads it),
    ``qk_norm``, the QKV bias, tied embeddings and a vocab of 100 padded
    to 128.  ``"ssm"``, ``"hybrid"``, ``"audio"`` and ``"vision"`` are the
    reduced mamba2-130m, recurrentgemma-9b, hubert-xlarge and internvl2-2b
    (``TP_FAMILIES``) in fp32 with ``optimizer``."""
    from repro_torch.configs import reduced_config

    if variant in TP_FAMILIES:
        return reduced_config(TP_FAMILIES[variant]).replace(dtype="float32", optimizer=optimizer)
    cfg = reduced_config("deepseek-7b").replace(dtype="float32", optimizer=optimizer)
    if variant == "gqa":
        cfg = cfg.replace(n_kv_heads=1, qk_norm=True, qkv_bias=True, tie_embeddings=True, vocab=100)
    elif variant != "dense":
        raise ValueError(f"unknown variant {variant!r}; use 'dense', 'gqa' or one of {sorted(TP_FAMILIES)}")
    return cfg


def tp_batch(cfg, batch: int, seq: int, device) -> dict:
    """One seeded global batch of (``batch``, ``seq``) for ``cfg``'s train
    step: tokens and next-token labels, or a frontend model's inputs (the
    synthetic data pipeline's first batch: frame embeddings and mask, or
    patches before ``seq - n_patches`` text tokens)."""
    if cfg.frontend is not None:
        from repro_torch.data import SyntheticLMDataset
        from repro_torch.models import ShapeSpec

        b = SyntheticLMDataset(cfg, ShapeSpec("tp", "train", seq, batch), seed=1).batch_for_step(0)
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    tokens = torch.randint(0, cfg.vocab, (batch, seq + 1), generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    return {"tokens": tokens[:, :-1].to(device), "labels": tokens[:, 1:].to(device)}


def tp_train(device="cuda", cfg=None, *, steps: int = TP_STEPS, batch: int = TP_BATCH, seq: int = TP_SEQ,
             n_microbatches: int = 1, grad_compression: bool = False) -> dict:
    """``steps`` train steps of ``cfg`` (default :func:`tp_config`'s) from
    the state seeded with 0, every step on one seeded global batch of
    (``batch``, ``seq``) (:func:`tp_batch`): tensor- and data-parallel under an active mesh
    with a ``model`` axis, one process off it.  → {"losses", "grad_norms",
    "params" (name → this rank's part, float32 numpy), "shards" (name →
    (full shape, index) or None off a ``model`` axis), "bytes" (this rank's
    parameters, gradients and optimizer state)}.  :func:`gather_params`
    puts the ranks' parts together: the caller does, not the step."""
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.runtime.train import build_train_step, init_train_state, state_bytes

    device = resolve_device(device)
    cfg = cfg if cfg is not None else tp_config()
    state = init_train_state(cfg, 0, device=device)
    art = build_train_step(cfg, n_microbatches=n_microbatches, grad_compression=grad_compression)
    b = tp_batch(cfg, batch, seq, device)
    losses, grad_norms = [], []
    for _ in range(steps):
        state, metrics = art(state, b)
        losses.append(float(metrics["loss"]))
        grad_norms.append(float(metrics["grad_norm"]))
    model = state.params
    shards = model.shards
    return {"losses": losses, "grad_norms": grad_norms,
            "params": {n: p.detach().float().cpu().numpy() for n, p in model.named_parameters()},
            "shards": {n: None if shards is None else (shards[n].full, shards[n].index)
                       for n, _ in model.named_parameters()},
            "bytes": state_bytes(state, art)}


def replicated_names(rank: dict) -> list:
    """The parameters a :func:`tp_train` (or :func:`dp_train`) result holds
    whole."""
    shards = rank.get("shards") or {}
    return [n for n, p in rank["params"].items() if shards.get(n) is None or tuple(shards[n][0]) == p.shape]


def gather_params(ranks: list) -> dict:
    """Whole parameters (name → numpy) from the ranks' :func:`tp_train`
    results: each sharded one put together from its parts, each other one
    rank 0's."""
    out = {}
    whole_names = set(replicated_names(ranks[0]))
    for name, part in ranks[0]["params"].items():
        if name in whole_names:
            out[name] = part
            continue
        sh = ranks[0]["shards"][name]
        whole = np.zeros(sh[0], dtype=part.dtype)
        for r in ranks:
            whole[r["shards"][name][1]] = r["params"][name]
        out[name] = whole
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="the data- or tensor-parallel train step over spawned rank processes")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--pods", type=int, default=1, help="a 'pod' axis of this size (pod x data)")
    ap.add_argument("--model", type=int, default=1,
                    help="a 'model' axis of this size: the tensor-parallel step (tp_train)")
    ap.add_argument("--device", default="cuda", help="'cuda' (NCCL, one card a rank) or 'cpu' (gloo)")
    args = ap.parse_args(argv)

    from repro_torch.kernels.dispatch import resolve_device

    device = resolve_device(args.device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if args.ranks % (args.pods * args.model):
        raise ValueError(f"--pods {args.pods} x --model {args.model} does not divide --ranks {args.ranks}")
    shape = (args.pods, args.ranks // (args.pods * args.model), args.model)
    axes = ("pod", "data", "model")
    keep = [i for i, n in enumerate(shape) if n > 1 or axes[i] == "data"]
    shape, axes = tuple(shape[i] for i in keep), tuple(axes[i] for i in keep)
    run = tp_train if args.model > 1 else dp_train
    t0 = time.perf_counter()
    ranks = spawn_mesh(functools.partial(run, str(device)), args.ranks, shape, axes, backend=backend,
                       timeout=600.0)
    wall = time.perf_counter() - t0
    one = run(str(device))
    params = gather_params(ranks) if args.model > 1 else ranks[0]["params"]
    worst = max(float(np.abs(params[n] - one["params"][n]).max()) for n in one["params"])
    # replicated parameters are the same bits on every rank
    same = all(np.array_equal(r["params"][n], ranks[0]["params"][n]) for r in ranks for n in replicated_names(r))
    print(f"[mesh] {args.ranks} ranks ({backend}, mesh {dict(zip(axes, shape))}): losses "
          f"{ranks[0]['losses']}, grad norms {ranks[0]['grad_norms']} in {wall:.1f} s with start-up; "
          f"one process: {one['losses']}, {one['grad_norms']}; "
          f"ranks' parameters equal: {same}; max |rank - one process| = {worst:.3e}")
    return {"ranks": ranks, "one": one, "max_diff": worst, "ranks_equal": same}


if __name__ == "__main__":
    main()
