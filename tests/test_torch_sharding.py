"""The port's mesh layer: ``dist.sharding`` (``use_mesh`` nesting, a helper
thread that sees no mesh, ``safe_spec`` equal to ``repro``'s over a table,
the DTensor placements), the ``axis=`` collectives and
``hierarchical_psum`` in 4 spawned gloo processes on a (2, 2) ``pod`` ×
``data`` mesh (bit-exact against the flat sum of integer-valued float32),
``launch.mesh``, and the data-parallel train step in 2 (data) and 4
(pod × data) gloo processes against one process's step on the same
global batch."""
from __future__ import annotations

import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.dist import collectives as coll  # noqa: E402
from repro_torch.dist.sharding import (  # noqa: E402
    PartitionSpec,
    current_mesh,
    default_rules,
    named_sharding,
    safe_spec,
    shard,
    use_mesh,
)
from repro_torch.launch import mesh as launch_mesh  # noqa: E402


class FakeMesh:
    """A mesh-like object: the axis sizes, no process group."""

    def __init__(self, **sizes):
        self.shape = sizes


class FakeDeviceMesh:
    """``DeviceMesh``'s naming surface (``mesh_dim_names`` / ``size(i)``)."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = tuple(sizes.values())

    def size(self, i):
        return self._sizes[i]


def test_use_mesh_nests_and_restores_and_helper_threads_see_none():
    m1, m2 = FakeMesh(data=1, model=1), FakeMesh(data=1)
    assert current_mesh() is None
    seen = []
    with use_mesh(m1):
        assert current_mesh() is m1
        with use_mesh(m2):
            assert current_mesh() is m2
            t = threading.Thread(target=lambda: seen.append(current_mesh()))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        assert current_mesh() is m1
    assert current_mesh() is None
    assert seen == [None]  # a helper thread starts from an empty context
    x = torch.ones(4, 2)
    with use_mesh(m1):
        assert shard(x, "batch", None) is x  # a plain local tensor is left as it is
    assert shard(x, "batch", None) is x  # off-mesh: the identity


SPEC_CASES = [
    # (shape, logical axes, mesh axis sizes)
    ((8, 16, 32), ("experts", "embed", "expert_ff"), dict(data=4, model=8)),
    ((8, 40), ("batch", "heads"), dict(data=1, model=1)),
    ((40, 64), ("heads", "ff"), dict(data=16, model=16)),
    ((64, 128), ("batch", "vocab"), dict(pod=2, data=16, model=16)),
    ((48, 128), ("batch", "kv_seq"), dict(pod=2, data=16, model=16)),  # pod dropped: 48 % 32
    ((6, 10), ("batch", "ff"), dict(pod=2, data=4, model=2)),  # neither 8 nor 4 divides 6
    ((4, 7, 9), ("batch", "act_seq", None), dict(data=2)),
    ((3,), ("layers",), dict(data=2, model=2)),
    ((16, 8, 4), ("kv_heads", "heads", "head_dim"), dict(model=4)),
]


@pytest.mark.parametrize("shape,axes,sizes", SPEC_CASES)
def test_safe_spec_equals_repro(shape, axes, sizes):
    from repro.dist.sharding import safe_spec as jax_safe_spec

    want = tuple(jax_safe_spec(shape, axes, mesh=FakeMesh(**sizes)))
    got = safe_spec(shape, axes, mesh=FakeMesh(**sizes))
    assert isinstance(got, PartitionSpec) and tuple(got) == want
    # a DeviceMesh's names and sizes give the same spec
    assert tuple(safe_spec(shape, axes, mesh=FakeDeviceMesh(**sizes))) == want


def test_safe_spec_uses_each_mesh_axis_once():
    spec = safe_spec((8, 16, 32), ("experts", "embed", "expert_ff"), mesh=FakeMesh(data=4, model=8))
    assert spec[0] == "model" and spec[1] is None and spec[2] is None
    assert safe_spec((40, 64), ("heads", "ff"), mesh=FakeMesh(data=16, model=16),
                     rules=default_rules()) == PartitionSpec(None, "model")
    assert safe_spec((2, 3), ("batch", None)) == PartitionSpec(None, None)  # off-mesh
    with pytest.raises(ValueError, match="rank mismatch"):
        safe_spec((2, 3), ("batch",))


def test_named_sharding_placements():
    from torch.distributed.tensor import Replicate, Shard

    with pytest.raises(RuntimeError, match="use_mesh"):
        named_sharding((8, 16), ("batch", "ff"))
    with use_mesh(FakeDeviceMesh(pod=2, data=2, model=2)):
        assert named_sharding((8, 16), ("batch", "ff")) == (Shard(0), Shard(0), Shard(1))
        assert named_sharding((6, 16), ("batch", "embed")) == (Replicate(), Shard(0), Replicate())


# ---------------------------------------------------------------------------
# Spawned gloo process groups (launch.mesh.spawn_mesh).
# ---------------------------------------------------------------------------

def _collectives_rank(n):
    """One rank of a (2, 2) pod × data mesh: integer-valued float32
    inputs, each collective against the flat sum computed from every rank's
    input.  Returns the failures (empty when all hold)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.dist.sharding import mesh_shape

    mesh = current_mesh()
    rank, bad = dist.get_rank(), []
    xs = [(torch.arange(n, dtype=torch.float32) % 13.0) + 7.0 * (r + 1) for r in range(4)]
    x = xs[rank].clone()
    pod, data = mesh.get_local_rank("pod"), mesh.get_local_rank("data")
    same_pod = [r for r in range(4) if r // 2 == pod]
    same_data = [r for r in range(4) if r % 2 == data]
    checks = {
        "sum data": (coll.all_reduce(x, axis="data"), sum(xs[r] for r in same_pod)),
        "sum pod": (coll.all_reduce(x, axis="pod"), sum(xs[r] for r in same_data)),
        "sum pod x data": (coll.all_reduce(x, axis=("pod", "data")), sum(xs)),
        "mean data": (coll.all_reduce(x, axis="data", op="mean"), sum(xs[r] for r in same_pod) / 2),
        "gather data": (coll.all_gather(x, axis="data"), torch.stack([xs[r] for r in same_pod])),
        "gather pod 2-D": (coll.all_gather(x.reshape(-1, 1), axis="pod"),
                           torch.stack([xs[r].reshape(-1, 1) for r in same_data])),
        "hierarchical": (coll.hierarchical_psum(x), sum(xs)),
        "hierarchical 2-D": (coll.hierarchical_psum(x.reshape(1, n)), sum(xs).reshape(1, n)),
    }
    for name, (got, want) in checks.items():
        if got.shape != want.shape or not torch.equal(got, want):
            bad.append(name)
    if not torch.equal(x, xs[rank]):
        bad.append("input written")
    if mesh_shape(mesh) != {"pod": 2, "data": 2}:
        bad.append("mesh shape")
    # a DTensor laid out by logical axes
    dt = distribute_tensor(torch.arange(8.0).reshape(4, 2), mesh, [Replicate(), Replicate()])
    sh = shard(dt, "batch", None)
    if not isinstance(sh, DTensor) or sh.placements != (Shard(0), Shard(0)) \
            or not torch.equal(sh.full_tensor(), torch.arange(8.0).reshape(4, 2)):
        bad.append("shard")
    # a step built under the mesh runs on it from a thread that sees none
    from repro_torch.configs import reduced_config
    from repro_torch.runtime.train import build_train_step, init_train_state

    cfg = reduced_config("deepseek-7b").replace(dtype="float32")
    states = [init_train_state(cfg, 0, device="cpu") for _ in range(2)]
    art = build_train_step(cfg)
    tokens = torch.randint(0, cfg.vocab, (4, 9), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    seen = {}
    t = threading.Thread(target=lambda: seen.update(mesh=current_mesh(), m=art(states[0], batch)[1]))
    t.start()
    t.join(timeout=60)
    _, inside = art(states[1], batch)
    if t.is_alive() or seen.get("mesh") is not None or not torch.equal(seen["m"]["loss"], inside["loss"]):
        bad.append("step off the mesh's thread")
    # the data-parallel step on pod x data (hierarchical_psum) against one
    # process's step, which a helper thread (no mesh) runs
    one = {}
    t = threading.Thread(target=lambda: one.update(launch_mesh.dp_train(device="cpu")))
    t.start()
    t.join(timeout=60)
    dp = launch_mesh.dp_train(device="cpu")
    if t.is_alive() or not np.allclose(dp["grad_norms"], one["grad_norms"], rtol=1e-6, atol=0) \
            or any(np.abs(dp["params"][n] - p).max() > 1e-6 for n, p in one["params"].items()):
        bad.append("data-parallel step on pod x data")
    host = launch_mesh.make_host_mesh()
    if mesh_shape(host) != {"data": 2, "model": 2}:
        bad.append("make_host_mesh")
    try:
        launch_mesh.make_production_mesh()
        bad.append("production mesh on 4 ranks")
    except RuntimeError as e:
        if "needs 256 ranks" not in str(e):
            bad.append(f"production mesh error: {e}")
    return bad


def test_axis_collectives_and_hierarchical_psum_in_four_gloo_processes():
    # 1001 elements: not a multiple of the inner axis, so the pad is taken
    results = launch_mesh.spawn_mesh(_collectives_rank, 4, (2, 2), ("pod", "data"), 1001,
                                     timeout=90.0)
    assert results == [[], [], [], []]


def test_data_parallel_step_in_two_gloo_processes_matches_one_process():
    ranks = launch_mesh.spawn_mesh(functools.partial(launch_mesh.dp_train, "cpu"), 2, (2,), ("data",),
                                   timeout=90.0)
    one = launch_mesh.dp_train("cpu")
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-6, atol=1e-6)
        # AdamW and the clip do not see a constant gradient scale; the norms
        # show the ranks' gradients were averaged, not summed
        np.testing.assert_allclose(r["grad_norms"], one["grad_norms"], rtol=1e-6)
        assert set(r["params"]) == set(one["params"])
        for n, p in one["params"].items():
            np.testing.assert_allclose(r["params"][n], p, rtol=0, atol=1e-6, err_msg=n)
            np.testing.assert_array_equal(r["params"][n], ranks[0]["params"][n])  # ranks agree


def test_model_axis_raises_and_axis_needs_a_mesh():
    """Reduced mamba2-130m (block kind ``"ssm"``, once refused here naming
    Queue 1 item 5.6) builds its train step on a model axis of 2, its SSM
    split by channels (the dense step is ``tests/test_torch_tp.py``'s, the
    MoE and MLA ones ``tests/test_torch_tp_moe_mla.py``'s, the SSM, RG-LRU
    and frontend ones ``tests/test_torch_tp_ssm_rec_frontends.py``'s); an
    axis collective needs a mesh and a host mesh a process group."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import Transformer
    from repro_torch.runtime.train import build_train_step

    cfg = reduced_config("mamba2-130m")
    with use_mesh(FakeMesh(data=1, model=2)):
        build_train_step(cfg)
        ssm = Transformer(cfg, device="meta").layers[0].ssm
    assert ssm.tp.size == 2 and ssm.split == {"in_proj", "conv_w", "conv_b"}
    assert tuple(ssm.norm.shape) == (64,) and tuple(ssm.A_log.shape) == (16,)
    with pytest.raises(ValueError, match="mesh"):
        coll.all_reduce(torch.ones(2), axis="data")
    with pytest.raises(RuntimeError, match="init_process_group"):
        launch_mesh.make_host_mesh()


def test_dp_train_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_mesh.dp_train()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_mesh.main(["--ranks", "1"])
