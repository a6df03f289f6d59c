"""Checkpointing of the train state with async commit.  A port of
``repro.checkpoint.manager`` with the same on-disk layout, so a checkpoint
written by either package restores in the other, bit for bit.

Layout (per step)::

    <dir>/step_000000042.tmp/       (written first)
        MANIFEST.json               (leaf paths, files, shapes, dtypes, crc32s)
        leaf_00000.shard-0.npy ...  (one file per leaf of repro's tree)
    <dir>/step_000000042/           (atomic rename on commit)

* **the tree**: :func:`~repro_torch.bridge.train_state_to_numpy` lays the
  port's ``TrainState`` out as ``repro``'s (layer parameters stacked, the
  optimizer state keyed by leaf path), and each leaf is stored under the
  path string ``repro`` gives it (``.params/['layers']/['attn']/['wq']``);
* **bfloat16**: numpy has no bfloat16, so its leaves go to disk as the raw
  2-byte records ``repro``'s ``np.save`` writes (header descr ``<V2``,
  manifest dtype ``"bfloat16"``) and come back through a ``uint16`` view,
  never rounded through float32;
* **atomicity**: a crash mid-write leaves only a ``.tmp`` dir, which restore
  ignores and the next manager purges (on a group of more than one rank,
  rank 0 purges them at the start of a save, when every rank has reached
  it: a manager made on one rank must not remove another's save in
  flight);
* **async commit**: the device→host copy runs on the caller's thread (so
  the train loop may update the state in place right after ``save``
  returns), serialization + fsync on a background thread;
* **integrity**: per-leaf crc32 in the manifest, verified on restore;
* **retention**: keep the newest ``keep`` checkpoints.

**On a mesh** (a process group of more than one rank; every rank calls
``save`` and ``restore``), the state is saved as ``repro``'s multi-host
posture lays it out: each leaf's spec (``runtime.train.train_state_shardings``
of the model's mesh: the parameters and AdamW's ``m`` / ``v`` by their
``ParamDef`` axes, the rest replicated) goes into the manifest, and every
distinct shard is written once, as ``leaf_i.shard-<k>.npy`` (k numbers the
shard over the spec's mesh axes), by the rank whose coordinates on the
mesh's other axes are all 0.  Each writer lists its shards in a manifest
fragment; after a barrier rank 0 merges them into ``MANIFEST.json``
(``shards``: file, start / stop of each dim, crc32) and commits the
directory, and a second barrier lets every rank see it.  This commit runs
on the caller's thread.  A replicated leaf keeps the one-file entry, so a
checkpoint of an unsharded state is the same directory either way.

``restore(template)`` lays the state out as the template's model is laid
out: each rank reads, leaf by leaf, the shards that overlap its part and
keeps that part (host memory: its own parts plus one leaf).  So a
checkpoint written off-mesh restores onto a mesh, one written on a mesh
restores off-mesh, and one written on a (2, 2) data × model mesh restores
onto the (1, 2) mesh of ``dist.fault.remesh_plan`` (the elastic re-mesh).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from typing import Optional

import numpy as np

from repro_torch.bridge import BF16_RAW, train_state_from_numpy, train_state_to_numpy
from repro_torch.dist.sharding import PartitionSpec, current_mesh, mesh_shape, spec_axes, use_mesh
from repro_torch.models.param import local_index
from repro_torch.optim import TrainState


def _flatten(tree, prefix: str) -> list[tuple[str, np.ndarray]]:
    """(path, leaf) pairs in ``jax.tree_util``'s order (dict keys sorted),
    with its path strings."""
    if not isinstance(tree, dict):
        return [(prefix, np.asarray(tree))]
    out = []
    for k in sorted(tree):
        out += _flatten(tree[k], f"{prefix}/['{k}']")
    return out


def _flatten_specs(tree, prefix: str) -> dict:
    """{path: PartitionSpec} with :func:`_flatten`'s paths."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flatten_specs(tree[k], f"{prefix}/['{k}']"))
    return out


def _state_specs(state: TrainState, mesh) -> dict:
    """Every leaf's ``PartitionSpec`` on ``mesh`` (all replicated off-mesh),
    keyed by its checkpoint path."""
    from repro_torch.runtime.train import train_state_shardings

    with use_mesh(mesh):
        sh = train_state_shardings(state.params.cfg)
    return {".step": PartitionSpec(), **_flatten_specs(sh.params, ".params"), **_flatten_specs(sh.opt, ".opt")}


def _group_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _shard_number(spec, mesh) -> tuple[int, bool]:
    """(this rank's shard number over the spec's mesh axes, whether it
    writes that shard: its coordinates on the mesh's other axes are 0)."""
    if mesh is None:
        import torch.distributed as dist

        return 0, dist.get_rank() == 0
    used = [a for e in spec for a in spec_axes(e)]
    sizes = mesh_shape(mesh)
    k = 0
    for a in used:
        k = k * sizes[a] + mesh.get_local_rank(a)
    writer = all(mesh.get_local_rank(a) == 0 for a in sizes if a not in used)
    return k, writer


def _full_index(shape) -> tuple[slice, ...]:
    return tuple(slice(0, n) for n in shape)


def _checked_load(d: str, fname: str, crc32: int, path: str) -> np.ndarray:
    arr = np.load(os.path.join(d, fname))
    if zlib.crc32(arr.tobytes()) & 0xFFFFFFFF != crc32:
        raise IOError(f"checkpoint corruption in {fname} ({path})")
    return arr


_KEY = re.compile(r"\['([^']*)'\]")


def _unflatten(pairs) -> dict:
    """Inverse of :func:`_flatten` over a whole state: → {"step", "params", "opt"}."""
    root: dict = {}
    for path, arr in pairs:
        head, _, rest = path.partition("/")
        node = root
        keys = [head.lstrip(".")] + _KEY.findall(rest)
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return root


def _save_leaf(path: str, arr: np.ndarray) -> None:
    if arr.dtype != BF16_RAW:
        np.save(path, arr)
        return
    # repro's np.save of an ml_dtypes bfloat16 array writes descr '<V2'
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_commit: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_commit = async_commit
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if _group_size() == 1:  # a group's ranks purge in _save_sharded
            self._purge_tmp()

    def _purge_tmp(self) -> None:
        """Remove the ``.tmp`` dirs a crash left."""
        for d in os.listdir(self.dir):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # ------------------------------------------------------------------ save

    def save(self, step: int, state: TrainState, *, block: bool = False) -> None:
        """Copy ``state`` to the host now; write it as step ``step`` on a
        background thread (at once with ``block`` or ``async_commit=False``;
        on a mesh of more than one rank, at once and together with the
        other ranks: module docstring)."""
        self.wait()  # one in-flight commit at a time
        p_tree, o_tree, s = train_state_to_numpy(state)
        leaves = ([(".step", np.asarray(s, np.int32))]
                  + _flatten(p_tree, ".params") + _flatten(o_tree, ".opt"))
        if _group_size() > 1:
            self._save_sharded(step, state, leaves)
            return

        def commit():
            tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
            final = os.path.join(self.dir, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "leaves": []}
            for i, (p, arr) in enumerate(leaves):
                fname = f"leaf_{i:05d}.shard-0.npy"
                _save_leaf(os.path.join(tmp, fname), arr)
                manifest["leaves"].append(
                    {
                        "path": p,
                        "file": fname,
                        "shape": list(arr.shape),
                        "dtype": "bfloat16" if arr.dtype == BF16_RAW else str(arr.dtype),
                        "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
                    }
                )
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._retain()

        if self.async_commit and not block:
            def run():
                try:
                    commit()
                except BaseException as e:  # re-raised by wait() on the caller's thread
                    self._error = e

            self._pending = threading.Thread(target=run, daemon=True)
            self._pending.start()
        else:
            commit()

    def _save_sharded(self, step: int, state: TrainState, leaves: list) -> None:
        import torch.distributed as dist

        tp = state.params.tp
        mesh = tp.mesh if tp is not None else current_mesh()
        specs = _state_specs(state, mesh)
        rank = dist.get_rank()
        tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
        final = os.path.join(self.dir, f"step_{step:09d}")
        if rank == 0:
            self._purge_tmp()
        dist.barrier()  # every rank is here: no save of this group is in flight
        os.makedirs(tmp, exist_ok=True)
        fragment = []
        for i, (p, arr) in enumerate(leaves):
            spec = specs[p]
            k, writer = _shard_number(spec, mesh)
            if not writer:
                continue
            full = tuple(arr.shape) if mesh is None else _whole_shape(arr.shape, spec, mesh)
            index = _full_index(full) if mesh is None else local_index(full, spec, mesh)
            fname = f"leaf_{i:05d}.shard-{k}.npy"
            _save_leaf(os.path.join(tmp, fname), arr)
            fragment.append({"leaf": i, "path": p, "shape": list(full), "spec": [list(spec_axes(e)) for e in spec],
                             "dtype": "bfloat16" if arr.dtype == BF16_RAW else str(arr.dtype),
                             "shard": {"file": fname, "start": [x.start for x in index],
                                       "stop": [x.stop for x in index],
                                       "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF}})
        with open(os.path.join(tmp, f"MANIFEST.rank-{rank}.json"), "w") as f:
            json.dump(fragment, f)
            f.flush()
            os.fsync(f.fileno())
        dist.barrier()
        if rank == 0:
            by_leaf: dict = {}
            for name in sorted(os.listdir(tmp)):
                if name.startswith("MANIFEST.rank-"):
                    with open(os.path.join(tmp, name)) as f:
                        for e in json.load(f):
                            by_leaf.setdefault(e["leaf"], []).append(e)
                    os.remove(os.path.join(tmp, name))
            manifest = {"step": step, "leaves": []}
            for i in range(len(leaves)):
                es = by_leaf[i]
                head = {k: es[0][k] for k in ("path", "shape", "dtype")}
                if any(es[0]["spec"]):
                    head["spec"] = es[0]["spec"]
                    head["shards"] = sorted((e["shard"] for e in es), key=lambda sh: sh["file"])
                else:
                    head.update(file=es[0]["shard"]["file"], crc32=es[0]["shard"]["crc32"])
                manifest["leaves"].append(head)
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._retain()
        dist.barrier()

    def wait(self) -> None:
        """Join the in-flight commit; raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: TrainState, step: Optional[int] = None) -> tuple[int, TrainState]:
        """→ (step, a new ``TrainState``) for ``template``'s config, optimizer,
        device and mesh (its tensors are not reused; each rank gets its part
        of every leaf: module docstring); the newest step by default.
        Raises ``IOError`` on a crc32 mismatch."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        tp = template.params.tp
        mesh = None if tp is None else tp.mesh
        specs = _state_specs(template, mesh) if mesh is not None else {}
        pairs = []
        for e in manifest["leaves"]:
            full = tuple(e["shape"])
            want = _full_index(full) if mesh is None else local_index(full, specs[e["path"]], mesh)
            pairs.append((e["path"], _read_part(d, e, want)))
        tree = _unflatten(pairs)
        cfg = template.params.cfg
        with use_mesh(mesh):  # the template's model layout (None: off-mesh)
            state = train_state_from_numpy(tree["params"], tree["opt"], tree["step"], cfg,
                                           device=template.step.device)
        return step, state


def _whole_shape(part_shape, spec, mesh) -> tuple:
    sizes = mesh_shape(mesh)
    out = []
    for n, e in zip(part_shape, spec):
        k = 1
        for a in spec_axes(e):
            k *= sizes[a]
        out.append(n * k)
    return tuple(out)


def _read_part(d: str, e: dict, want: tuple) -> np.ndarray:
    """The part ``want`` (a slice a dim) of the leaf of manifest entry
    ``e``, read from the files that hold it (each crc32-checked whole)."""
    def check_dtype(arr, fname):
        if not (e["dtype"] == "bfloat16" and arr.dtype == BF16_RAW) and str(arr.dtype) != e["dtype"]:
            raise IOError(f"checkpoint {fname} ({e['path']}): dtype {arr.dtype}, manifest {e['dtype']}")

    if "file" in e:  # one file holds the whole leaf
        arr = _checked_load(d, e["file"], e["crc32"], e["path"])
        check_dtype(arr, e["file"])
        return arr if all(w.stop - w.start == n for w, n in zip(want, arr.shape)) else arr[want].copy()
    out = None
    for sh in e["shards"]:
        lo = [max(w.start, a) for w, a in zip(want, sh["start"])]
        hi = [min(w.stop, b) for w, b in zip(want, sh["stop"])]
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        arr = _checked_load(d, sh["file"], sh["crc32"], e["path"])
        check_dtype(arr, sh["file"])
        if out is None:
            out = np.empty(tuple(w.stop - w.start for w in want), dtype=arr.dtype)
        dst = tuple(slice(a - w.start, b - w.start) for a, b, w in zip(lo, hi, want))
        src = tuple(slice(a - s0, b - s0) for a, b, s0 in zip(lo, hi, sh["start"]))
        out[dst] = arr[src]
        del arr
    if out is None:
        raise IOError(f"checkpoint {e['path']}: no shard holds the part {want}")
    return out
