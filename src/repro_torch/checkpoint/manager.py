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
  ignores and the next manager purges;
* **async commit**: the device→host copy runs on the caller's thread (so
  the train loop may update the state in place right after ``save``
  returns), serialization + fsync on a background thread;
* **integrity**: per-leaf crc32 in the manifest, verified on restore;
* **retention**: keep the newest ``keep`` checkpoints.
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
        # purge stale tmp dirs from a previous crash
        for d in os.listdir(directory):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(directory, d), ignore_errors=True)

    # ------------------------------------------------------------------ save

    def save(self, step: int, state: TrainState, *, block: bool = False) -> None:
        """Copy ``state`` to the host now; write it as step ``step`` on a
        background thread (at once with ``block`` or ``async_commit=False``)."""
        self.wait()  # one in-flight commit at a time
        p_tree, o_tree, s = train_state_to_numpy(state)
        leaves = ([(".step", np.asarray(s, np.int32))]
                  + _flatten(p_tree, ".params") + _flatten(o_tree, ".opt"))

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
        """→ (step, a new ``TrainState``) for ``template``'s config, optimizer
        and device (its tensors are not reused); the newest step by
        default.  Raises ``IOError`` on a crc32 mismatch."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        pairs = []
        for e in manifest["leaves"]:
            arr = np.load(os.path.join(d, e["file"]))
            if e["dtype"] == "bfloat16" and arr.dtype == BF16_RAW:
                pass  # raw records, as written
            elif str(arr.dtype) != e["dtype"]:
                raise IOError(f"checkpoint {e['file']} ({e['path']}): dtype {arr.dtype}, "
                              f"manifest {e['dtype']}")
            crc = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
            if crc != e["crc32"]:
                raise IOError(f"checkpoint corruption in {e['file']} ({e['path']})")
            pairs.append((e["path"], arr))
        tree = _unflatten(pairs)
        cfg = template.params.cfg
        state = train_state_from_numpy(tree["params"], tree["opt"], tree["step"], cfg,
                                       device=template.step.device)
        return step, state
