"""The port's CheckpointManager against ``repro``'s.

The port writes ``repro``'s on-disk layout (one ``.npy`` a leaf of
``repro``'s tree, under ``repro``'s leaf paths, bfloat16 as raw 2-byte
records), so a checkpoint written by either package restores bit-identical
in the other.  Also: save and restore within the port for both optimizers
and dtypes, an async save that a train step follows before its commit,
``.tmp`` purge, retention, crc32 corruption, an async commit's error, and a
resumed ``launch/train.py`` run against an unbroken one.
"""
from __future__ import annotations

import json
import os
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.runtime.train import abstract_train_state as jax_abstract_train_state  # noqa: E402
from repro.runtime.train import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch.bridge import train_state_to_numpy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint import manager as manager_mod  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.config import ShapeSpec  # noqa: E402
from repro_torch.runtime.train import build_train_step, init_train_state  # noqa: E402

pytestmark = pytest.mark.timeout(300)

CASES = [(opt, dt) for opt in ("adamw", "adafactor") for dt in ("float32", "bfloat16")]


def _cfg(opt, dtype):
    return reduced_config("deepseek-7b").replace(optimizer=opt, dtype=dtype)


def _batch(cfg, step):
    ds = SyntheticLMDataset(cfg, ShapeSpec("train", "train", 16, 4), seed=0)
    return {k: torch.from_numpy(v) for k, v in ds.batch_for_step(step).items()}


def _trained(opt, dtype, steps=2):
    """A port state after ``steps`` train steps: every optimizer leaf set."""
    cfg = _cfg(opt, dtype)
    state = init_train_state(cfg, 0, device="cpu")
    art = build_train_step(cfg, n_microbatches=1)
    for i in range(steps):
        state, _ = art(state, _batch(cfg, i))
    return cfg, state, art


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _port_bits(state) -> dict:
    """Every leaf of the port's state in repro's layout, as raw bytes."""
    p, o, step = train_state_to_numpy(state)
    leaves = {**_flat(p, "params"), **_flat(o, "opt"), "step": np.asarray(step, np.int32)}
    return {k: (v.shape, v.tobytes()) for k, v in leaves.items()}


def _jax_bits(state) -> dict:
    leaves = {**_flat(jax.tree.map(np.asarray, state.params), "params"),
              **_flat(jax.tree.map(np.asarray, state.opt), "opt"),
              "step": np.asarray(state.step, np.int32)}
    return {k: (v.shape, v.tobytes()) for k, v in leaves.items()}


@pytest.mark.parametrize("opt,dtype", CASES)
def test_save_restore_bit_identical_and_trains_on(tmp_path, opt, dtype):
    cfg, state, art = _trained(opt, dtype)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state)
    mgr.wait()
    step, restored = mgr.restore(init_train_state(cfg, 1, device="cpu"))
    assert step == 2 and int(restored.step) == 2
    assert _port_bits(restored) == _port_bits(state)
    assert all(p.requires_grad for p in restored.params.parameters())
    # both take the next step to the same bits
    b = _batch(cfg, 2)
    restored, m1 = art(restored, b)
    state, m2 = art(state, b)
    assert float(m1["loss"]) == float(m2["loss"])
    assert _port_bits(restored) == _port_bits(state)


@pytest.mark.parametrize("opt,dtype", CASES)
def test_async_save_is_not_touched_by_the_next_step(tmp_path, monkeypatch, opt, dtype):
    """``save`` copies the state on the caller's thread: a train step that
    updates the state in place while the commit is still writing leaves the
    checkpoint as the state was when ``save`` was called."""
    cfg, state, art = _trained(opt, dtype)
    saved = _port_bits(state)
    stepped = threading.Event()
    save_leaf = manager_mod._save_leaf

    def after_the_step(path, arr):  # the commit writes only once the step is done
        assert stepped.wait(timeout=120)
        save_leaf(path, arr)

    monkeypatch.setattr(manager_mod, "_save_leaf", after_the_step)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state)
    state, _ = art(state, _batch(cfg, 2))
    stepped.set()
    mgr.wait()
    assert _port_bits(state) != saved
    step, restored = mgr.restore(init_train_state(cfg, 1, device="cpu"))
    assert step == 2 and _port_bits(restored) == saved


def test_tmp_purge_and_keep_retention(tmp_path):
    _, state, _ = _trained("adafactor", "float32", steps=1)
    stale = tmp_path / "step_000000005.tmp"
    stale.mkdir()
    (stale / "leaf_00000.shard-0.npy").write_bytes(b"partial")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert not stale.exists()  # purged at start
    for s in (1, 2, 3):
        mgr.save(s, state)
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == ["step_000000002", "step_000000003"]


def test_crc32_corruption_detected(tmp_path):
    cfg, state, _ = _trained("adafactor", "bfloat16", steps=1)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, block=True)
    d = tmp_path / "step_000000001"
    manifest = json.loads((d / "MANIFEST.json").read_text())
    e = next(e for e in manifest["leaves"] if e["dtype"] == "bfloat16")
    raw = bytearray((d / e["file"]).read_bytes())
    raw[-1] ^= 0x40  # flip one bit of the last element
    (d / e["file"]).write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corruption"):
        mgr.restore(state)


def test_async_commit_error_is_raised_by_wait(tmp_path, monkeypatch):
    _, state, _ = _trained("adafactor", "float32", steps=1)
    mgr = CheckpointManager(str(tmp_path))

    def broken(path, arr):
        raise OSError("disk full")

    monkeypatch.setattr(manager_mod, "_save_leaf", broken)
    mgr.save(1, state)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # raised once
    assert mgr.all_steps() == []


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt,dtype", CASES)
def test_port_checkpoint_restores_in_repro(tmp_path, opt, dtype):
    """repro restores the port's checkpoint into its ``abstract_train_state``
    bit for bit, and saving it again writes the port's files byte for byte."""
    cfg, state, _ = _trained(opt, dtype)
    CheckpointManager(str(tmp_path / "port")).save(2, state, block=True)
    jcfg = jax_reduced_config("deepseek-7b").replace(optimizer=opt, dtype=dtype)
    jmgr = JaxCheckpointManager(str(tmp_path / "port"))
    step, jstate = jmgr.restore(jax_abstract_train_state(jcfg))
    assert step == 2
    assert _jax_bits(jstate) == _port_bits(state)
    JaxCheckpointManager(str(tmp_path / "jax")).save(2, jstate, block=True)
    a, b = tmp_path / "port" / "step_000000002", tmp_path / "jax" / "step_000000002"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("opt,dtype", CASES)
def test_repro_checkpoint_restores_in_port(tmp_path, opt, dtype):
    jcfg = jax_reduced_config("deepseek-7b").replace(optimizer=opt, dtype=dtype)
    jstate = jax_init_train_state(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(0)
    opt_tree = jax.tree.map(  # every optimizer leaf non-zero
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)).astype(a.dtype),
        jstate.opt)
    jstate = jstate._replace(step=jnp.int32(7), opt=opt_tree)
    JaxCheckpointManager(str(tmp_path)).save(7, jstate, block=True)
    step, state = CheckpointManager(str(tmp_path)).restore(
        init_train_state(_cfg(opt, dtype), 0, device="cpu"))
    assert step == 7 and int(state.step) == 7
    assert _port_bits(state) == _jax_bits(jstate)
    want = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    assert {want[p.dtype] for p in state.params.parameters()} == {dtype}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_launcher_resume_equals_unbroken_run(tmp_path, opt):
    base = ["--arch", "deepseek-7b", "--reduced", "--device", "cpu", "--batch", "4", "--seq", "16",
            "--microbatches", "2", "--log-every", "0", "--optimizer", opt]
    ck = ["--ckpt-dir", str(tmp_path)]
    unbroken = launch_train.main(base + ["--steps", "4"])
    first = launch_train.main(base + ck + ["--steps", "2", "--ckpt-every", "2"])
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]
    resumed = launch_train.main(base + ck + ["--steps", "4", "--resume"])
    assert first["losses"] + resumed["losses"] == unbroken["losses"]
    assert resumed["final_step"] == 4 and len(resumed["losses"]) == 2
    # nothing left to do once the newest checkpoint is the last step
    launch_train.main(base + ck + ["--steps", "4", "--ckpt-every", "4", "--resume"])
    done = launch_train.main(base + ck + ["--steps", "4", "--resume"])
    assert done == {"losses": [], "final_step": 4}
