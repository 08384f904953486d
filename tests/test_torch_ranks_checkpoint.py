"""Checkpoints of ranks that hold blocks, against the reference's
CheckpointManager.

One job of 4 CPU ranks (`run_ranks`; bodies in
`torch_ranks_bodies.checkpoints`) for each of a reduced llama3-8b (2
layers, f32; heads, ffn and vocabulary split over ``model``) and a
reduced qwen3-moe-30b-a3b (2 layers, f32; its 8 experts split too):

* `train_loop` on (1, 2), 4 steps, stopped at 2 with a checkpoint that
  the ranks gather and the all-zero position writes, then resumed by both:
  the resumed losses are the straight run's, bitwise;
* that step-2 checkpoint is, member by member (the ``.npy`` bytes of
  ``arrays.npz``, and ``manifest.json``), what the reference's
  ``CheckpointManager.save`` writes of the whole tree the ranks held,
  their blocks put together; the reference's ``restore`` reads it back
  to that tree;
* restored on (1, 4), on (2, 2) without and with ZeRO-1 (`interop.
  rank_state_from`) and on one process, every rank's parameter block and
  moment block is that leaf's block of the checkpoint, bitwise;
* a ZeRO-1 state (one train step on (2, 2)), whose moments the ranks hold
  cut over ``data`` as well, is gathered whole and written as the
  reference writes the blocks put together."""
import dataclasses
import json
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_ranks_bodies as bodies  # noqa: E402
from repro.runtime import CheckpointManager as RefCheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import (rank_state_from, reference_opt_state,  # noqa: E402
                                 reference_tree, state_template)
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.runtime import CheckpointManager  # noqa: E402

ARCHS = {"llama": "llama3-8b", "moe": "qwen3-moe-30b-a3b"}
LOOP = dict(steps=4, batch=4, seq=16, lr=1e-2)
HALF = LOOP["steps"] // 2
RESTORED = ("restored_1x4", "restored_2x2", "restored_2x2_zero1")


def _cfg(name):
    return dataclasses.replace(get_config(ARCHS[name]).reduced(), num_layers=2)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    store = tmp_path_factory.mktemp("ckpt_ranks")
    batches = [np.random.default_rng(1).integers(0, 512, (4, 16)).astype(np.int32)]
    got = run_ranks(bodies.checkpoints, 4, store / "job",
                    {name: _cfg(name) for name in ARCHS}, str(store), LOOP,
                    batches, device="cpu")
    return store, got


def _members(got, name, part):
    return [r[name][part] for r in got if part in r[name]]


def _assemble(members: list) -> tuple:
    """The whole ``(params, opt_state)`` tree of the blocks the ranks held
    (`torch_ranks_bodies._held`), as numpy; blocks two ranks hold must be
    equal."""
    flat = {"p": {}, "m": {}, "v": {}}
    for r in members:
        for path, leaf in r["leaves"].items():
            for part in flat:
                block = leaf["block"] if part == "p" else leaf["moment_block"]
                whole = flat[part].setdefault(
                    path, np.full(leaf["whole"], np.nan, dtype=leaf[part].dtype))
                region = whole[block]
                seen = ~np.isnan(region)
                np.testing.assert_array_equal(region[seen], leaf[part][seen])
                whole[block] = leaf[part]
    steps = {r["step"] for r in members}
    assert len(steps) == 1
    trees = {}
    for part, leaves in flat.items():
        tree = trees[part] = {}
        for path, whole in leaves.items():
            assert not np.isnan(whole).any(), path
            *keys, name = path.split("/")
            node = tree
            for k in keys:
                node = node.setdefault(k, {})
            node[name] = whole
    return trees["p"], {"m": trees["m"], "v": trees["v"],
                        "step": np.asarray(steps.pop(), dtype=np.int32)}


def _step_dir(root, step):
    return root / f"step_{step:09d}"


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("name", list(ARCHS))
def test_a_rank_checkpoint_resumes_bitwise(job, name):
    _, got = job
    runs = _members(got, name, "loop")
    assert len(runs) == 2
    for r in runs:
        assert r["straight"] == runs[0]["straight"]
        assert r["resumed"] == r["straight"]


@pytest.mark.parametrize("which", ["loop", "zero1"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_a_rank_checkpoint_is_the_reference_writers(job, tmp_path, name, which):
    """Member by member, the ranks' checkpoint is the reference
    CheckpointManager's write of the blocks put together (ZeRO-1's
    moment blocks too: the moments are cut over ``data`` there)."""
    store, got = job
    if which == "loop":
        members, root, step = ([r["held"] for r in _members(got, name, "loop")],
                               store / name, HALF)
    else:
        members, root, step = _members(got, name, "zero1"), store / f"{name}_zero1", 1
        assert any(leaf["moment_block"] != leaf["block"]
                   for r in members for leaf in r["leaves"].values())
    assert len(members) == (2 if which == "loop" else 4)
    tree = _assemble(members)
    RefCheckpointManager(tmp_path).save(step, tree)
    mine, ref = _step_dir(root, step), _step_dir(tmp_path, step)
    assert json.loads((mine / "manifest.json").read_text()) == \
        json.loads((ref / "manifest.json").read_text())
    assert (mine / "manifest.json").read_text() == (ref / "manifest.json").read_text()
    with zipfile.ZipFile(mine / "arrays.npz") as a, \
            zipfile.ZipFile(ref / "arrays.npz") as b:
        assert a.namelist() == b.namelist()
        for member in b.namelist():
            assert a.read(member) == b.read(member), member


@pytest.mark.parametrize("name", list(ARCHS))
def test_the_reference_restores_a_rank_checkpoint(job, name):
    store, got = job
    tree = _assemble([r["held"] for r in _members(got, name, "loop")])
    restored, step = RefCheckpointManager(store / name).restore(tree, step=HALF)
    assert step == HALF
    want, back = _flat(tree), _flat(restored)
    assert sorted(back) == sorted(want)
    for key, leaf in want.items():
        assert back[key].dtype == leaf.dtype
        np.testing.assert_array_equal(back[key], leaf, err_msg=key)


def _checkpoint(store, name) -> dict:
    with np.load(_step_dir(store / name, HALF) / "arrays.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("mesh", RESTORED)
@pytest.mark.parametrize("name", list(ARCHS))
def test_a_rank_checkpoint_restores_on_another_mesh(job, name, mesh):
    """On (1, 4), (2, 2) and (2, 2) with ZeRO-1 every rank's parameter and
    moment blocks are the leaf's blocks of the (1, 2) checkpoint, bitwise,
    and ``step`` is whole."""
    store, got = job
    ckpt = _checkpoint(store, name)
    members = _members(got, name, mesh)
    assert len(members) == 4
    for r in members:
        assert r["step"] == HALF
        for path, leaf in r["leaves"].items():
            np.testing.assert_array_equal(leaf["p"], ckpt[f"0/{path}"][leaf["block"]])
            for part in ("m", "v"):
                np.testing.assert_array_equal(
                    leaf[part], ckpt[f"1/{part}/{path}"][leaf["moment_block"]])
    if mesh.endswith("zero1"):  # the moments are cut over data as well
        assert any(leaf["moment_block"] != leaf["block"]
                   for r in members for leaf in r["leaves"].values())


@pytest.mark.parametrize("name", list(ARCHS))
def test_a_rank_checkpoint_restores_on_one_process(job, name):
    """Unsharded, the restored model and moments are the checkpoint's whole
    leaves, and they are the (1, 2) ranks' blocks put together."""
    store, got = job
    model = Model(_cfg(name), "cpu")
    state, step = CheckpointManager(store / name).restore(state_template(model),
                                                          step=HALF)
    opt = rank_state_from(model, state)
    tree = (reference_tree(model), reference_opt_state(model, opt))
    ckpt, held = _checkpoint(store, name), _flat(
        _assemble([r["held"] for r in _members(got, name, "loop")]))
    back = _flat(tree)
    assert sorted(back) == sorted(ckpt) == sorted(held)
    for key, leaf in back.items():
        np.testing.assert_array_equal(leaf, ckpt[key], err_msg=key)
        np.testing.assert_array_equal(leaf, held[key], err_msg=key)
