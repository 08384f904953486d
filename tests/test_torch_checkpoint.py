"""The port's CheckpointManager: the six cases of ``tests/test_checkpoint.py``
on torch trees, checkpoints crossing between the packages (a reference
checkpoint of an f32 tree restores in the port with equal values, and a
port checkpoint in the reference), a bfloat16 tree round-tripping bitwise
in the port, and the npz member of a bfloat16 leaf byte-equal to the
reference writer's."""
import json
import shutil
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.runtime import CheckpointManager as RefCheckpointManager  # noqa: E402
from repro_torch.runtime import CheckpointManager  # noqa: E402


def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {"params": {"w": torch.tensor(r.standard_normal((4, 4)), dtype=torch.float32),
                       "b": torch.tensor(r.standard_normal(4), dtype=torch.float32)},
            "opt": {"m": torch.zeros((4, 4)), "step": torch.tensor(7, dtype=torch.int32)}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    mgr.save(10, tree)
    restored, step = mgr.restore(tree)
    assert step == 10
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_latest_pointer_and_prune(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.latest_step() == 4
    assert sorted(mgr.all_steps()) == [3, 4]


def test_restore_ignores_uncommitted_tmp(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    mgr.save(5, tree)
    # simulate a crashed mid-write of step 6
    (tmp_path / "step_000000006.tmp").mkdir()
    (tmp_path / "step_000000006.tmp" / "arrays.npz").write_bytes(b"garbage")
    restored, step = mgr.restore(tree)
    assert step == 5


def test_latest_not_flipped_if_dir_missing(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, _tree())
    shutil.rmtree(tmp_path / "step_000000003")
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tree())


def test_async_save(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree(1)
    mgr.save_async(42, tree)
    mgr.wait()
    restored, step = mgr.restore(tree)
    assert step == 42
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  tree["params"]["w"].numpy())


def test_manifest_written(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    manifest = json.loads((tmp_path / "step_000000001" / "manifest.json").read_text())
    assert manifest["step"] == 1
    assert "params/w" in manifest["arrays"]


def _jax_tree(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _tree(2)
    RefCheckpointManager(tmp_path).save(8, (_jax_tree(tree), {"n": jnp.arange(3)}))
    template = (_tree(3), {"n": torch.zeros(3, dtype=torch.int32)})
    restored, step = CheckpointManager(tmp_path).restore(template)
    assert step == 8
    for a, b in zip(_leaves((tree, {"n": torch.arange(3, dtype=torch.int32)})),
                    _leaves(restored)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _tree(4)
    CheckpointManager(tmp_path).save(12, (tree, [torch.ones(2)]))
    template = (_jax_tree(_tree(5)), [jnp.zeros(2)])
    restored, step = RefCheckpointManager(tmp_path).restore(template)
    assert step == 12
    want = jax.tree.leaves(_jax_tree((tree, [torch.ones(2)])))
    got = jax.tree.leaves(restored)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _bf16_tree(seed=6):
    r = np.random.default_rng(seed)
    return {"w": torch.tensor(r.standard_normal((3, 5)), dtype=torch.float32)
            .to(torch.bfloat16),
            "s": torch.tensor(r.standard_normal(()), dtype=torch.float32)
            .to(torch.bfloat16),
            "m": torch.tensor(r.standard_normal(4), dtype=torch.float32)}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def _to_jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def test_a_bf16_tree_round_trips_bitwise(tmp_path):
    tree = _bf16_tree()
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tree)
    manifest = json.loads((tmp_path / "step_000000001" / "manifest.json").read_text())
    assert manifest["arrays"]["w"] == {"shape": [3, 5], "dtype": "bfloat16"}
    assert manifest["arrays"]["s"] == {"shape": [], "dtype": "bfloat16"}
    template = {k: torch.zeros_like(v) for k, v in tree.items()}
    restored, _ = mgr.restore(template)
    for k, v in tree.items():
        assert restored[k].dtype == v.dtype
        assert torch.equal(_bits(restored[k]), _bits(v)), k


def test_bf16_leaf_bytes_equal_the_reference_writers(tmp_path):
    tree = _bf16_tree(7)
    CheckpointManager(tmp_path / "port").save(1, tree)
    RefCheckpointManager(tmp_path / "ref").save(
        1, {k: _to_jax(v) for k, v in tree.items()})
    read = lambda d: zipfile.ZipFile(d / "step_000000001" / "arrays.npz")
    port, want = read(tmp_path / "port"), read(tmp_path / "ref")
    assert sorted(port.namelist()) == sorted(want.namelist())
    for name in want.namelist():
        assert port.read(name) == want.read(name), name
    manifest = lambda d: json.loads((d / "step_000000001" / "manifest.json").read_text())
    assert manifest(tmp_path / "port") == manifest(tmp_path / "ref")
