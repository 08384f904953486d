"""The port's elastic pieces: the three cases of ``tests/test_elastic.py``
on ``remesh_params`` and ``HeartbeatMonitor``, and the placement of a spec
that splits a mesh axis larger than 1 on a mesh of cards in one process
(tests/test_torch_ranks_elastic.py covers meshes of ranks)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import Mesh, make_local_mesh  # noqa: E402
from repro_torch.runtime import HeartbeatMonitor, Sharded, remesh_params  # noqa: E402


def test_remesh_preserves_values():
    mesh_a = make_local_mesh(device="cpu")
    mesh_b = make_local_mesh(device="cpu")  # "new" mesh after failure
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    specs = {"w": (None, None)}
    placed = remesh_params(tree, mesh_a, specs)
    moved = remesh_params(placed, mesh_b, specs)
    np.testing.assert_array_equal(moved["w"].numpy(), tree["w"].numpy())
    assert moved["w"].device == torch.device("cpu")


def test_remesh_places_a_split_axis_in_one_process():
    devices = np.empty(2, dtype=object)
    devices[:] = [torch.device("cpu")] * 2
    mesh = Mesh(("data", "model"), devices.reshape(1, 2))
    w = torch.arange(16.0).reshape(4, 4)
    tree = {"a": {"w": w}}
    # Replicated, or over the size-1 data axis: the whole leaf.
    placed = remesh_params(tree, mesh, {"a": {"w": ("data", None)}})
    assert torch.equal(placed["a"]["w"], w)
    # Over the model axis: one block a position, gathered back exactly.
    cols = remesh_params(tree, mesh, {"a": {"w": (None, "model")}})["a"]["w"]
    assert isinstance(cols, Sharded) and cols.shape == (4, 4)
    assert sorted(cols.blocks) == [(0, 0), (0, 1)]
    assert torch.equal(cols.blocks[(0, 1)], w[:, 2:])
    assert torch.equal(cols.full(), w)
    rows = remesh_params(tree, mesh, {"a": {"w": (("data", "model"), None)}})
    assert torch.equal(rows["a"]["w"].blocks[(0, 0)], w[:2])
    assert torch.equal(rows["a"]["w"].full(), w)
    # A placed tree moves back to a replicated spec whole.
    back = remesh_params(rows, mesh, {"a": {"w": (None, None)}})
    assert torch.equal(back["a"]["w"], w)


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
