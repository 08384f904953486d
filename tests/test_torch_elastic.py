"""The port's elastic pieces: the three cases of ``tests/test_elastic.py``
on ``remesh_params`` and ``HeartbeatMonitor``, and the refusal to shard
over a mesh axis larger than 1 (not ported: one card, no
``torch.distributed``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import Mesh, make_local_mesh  # noqa: E402
from repro_torch.runtime import HeartbeatMonitor, remesh_params  # noqa: E402


def test_remesh_preserves_values():
    mesh_a = make_local_mesh(device="cpu")
    mesh_b = make_local_mesh(device="cpu")  # "new" mesh after failure
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    specs = {"w": (None, None)}
    placed = remesh_params(tree, mesh_a, specs)
    moved = remesh_params(placed, mesh_b, specs)
    np.testing.assert_array_equal(moved["w"].numpy(), tree["w"].numpy())
    assert moved["w"].device == torch.device("cpu")


def test_remesh_refuses_a_split_axis():
    devices = np.empty(2, dtype=object)
    devices[:] = [torch.device("cpu")] * 2
    mesh = Mesh(("data", "model"), devices.reshape(1, 2))
    tree = {"a": {"w": torch.ones(4, 4)}}
    # Replicated, or over the size-1 data axis: placed.
    remesh_params(tree, mesh, {"a": {"w": ("data", None)}})
    with pytest.raises(NotImplementedError, match="model"):
        remesh_params(tree, mesh, {"a": {"w": (None, "model")}})
    with pytest.raises(NotImplementedError):
        remesh_params(tree, mesh, {"a": {"w": (("data", "model"), None)}})


def test_heartbeat_straggler_detection():
    mon = HeartbeatMonitor(num_hosts=4, window=8, threshold=1.5)
    for step in range(8):
        for h in range(4):
            mon.report(h, step, 1.0 if h != 2 else 3.0)
    assert mon.stragglers() == [2]


def test_rebalance_plan_conserves_shards():
    mon = HeartbeatMonitor(num_hosts=3, window=4)
    for step in range(4):
        mon.report(0, step, 1.0)
        mon.report(1, step, 1.0)
        mon.report(2, step, 5.0)
    before = {0: 4, 1: 4, 2: 4}
    after = mon.rebalance_plan(before)
    assert sum(after.values()) == 12
    assert after[2] < 4  # straggler sheds work
