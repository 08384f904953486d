"""`remesh_params` over split mesh axes, on gloo ranks.

tests/test_elastic.py's case — place a tree on mesh A, move it to mesh B,
every value preserved — with specs that split leaves over axes larger
than 1, on (data, model) rank meshes (`run_ranks`, 4 CPU ranks, one job):
the planner's parameter specs of a reduced qwen3-moe-30b-a3b (experts,
heads and vocabulary split over ``model``) on model axes of 2 and 4, a
leaf split over (data, model) 2x2 and over both axes at once, and moves
of the expert leaves and of the tensor-parallel leaves (embedding, head,
attention projections) from a 4-rank mesh to a 2-rank mesh (ranks 2 and
3 drop out).  Each rank's blocks must be its `shard_slices` of the leaf, and
the blocks gathered back (`Sharded.full`) the original, bit for bit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks_bodies as bodies  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import reference_tree  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sharding import ShardingPlan, plan_params, shard_slices  # noqa: E402

MESH = {(1, 2): {"data": 1, "model": 2}, (1, 4): {"data": 1, "model": 4},
        (2, 2): {"data": 2, "model": 2}}


def _tree():
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(),
                              num_layers=2)
    return _numpy(reference_tree(build_model(cfg, "cpu", seed=0)))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def _specs(shape, tree):
    return plan_params(ShardingPlan(mesh_shape=MESH[shape]), tree)


def _experts(tree):
    return {"layers": {"moe": {k: tree["layers"]["moe"][k]
                               for k in ("w_gate", "w_up", "w_down")}}}


def _dense(tree):
    attn = tree["layers"]["attn"]
    return {"embed": tree["embed"], "lm_head": tree["lm_head"],
            "layers": {"attn": {k: attn[k] for k in ("wq", "wk", "wv", "wo")}}}


def _cases(tree):
    experts, dense = _experts(tree), _dense(tree)
    return {
        "model2": dict(place=((1, 2), _specs((1, 2), tree))),
        "model4": dict(place=((1, 4), _specs((1, 4), tree))),
        "data_model": dict(place=((2, 2), {"grid": ("data", "model", None),
                                           "ids": (("data", "model"), None)})),
        "model_data": dict(place=((2, 2), {"grid": (("model", "data"), None, None),
                                           "ids": (None, None)})),
        "four_to_two": dict(place=((1, 4), _specs((1, 4), experts)),
                            move=((1, 2), _specs((1, 2), experts))),
        "dense_four_to_two": dict(place=((1, 4), _specs((1, 4), dense)),
                                  move=((1, 2), _specs((1, 2), dense))),
    }


TREES = {"model2": "params", "model4": "params", "data_model": "grid",
         "model_data": "grid", "four_to_two": "experts",
         "dense_four_to_two": "dense"}


@pytest.fixture(scope="module")
def inputs():
    tree = _tree()
    grid = {"grid": np.arange(8 * 12 * 5, dtype=np.float32).reshape(8, 12, 5),
            "ids": np.arange(16, dtype=np.int64).reshape(16, 1)}
    return ({"params": tree, "grid": grid, "experts": _experts(tree),
             "dense": _dense(tree)}, _cases(tree))


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    trees, cases = inputs
    per_case = {name: dict(case, tree=TREES[name]) for name, case in cases.items()}
    return run_ranks(bodies.remesh, 4, tmp_path_factory.mktemp("remesh_ranks"),
                     trees, per_case, device="cpu")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict) and "blocks" not in tree:
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", list(TREES))
def test_remesh_places_blocks_and_gathers_them_back_exactly(inputs, ranks, name):
    trees, cases = inputs
    whole = trees[TREES[name]]
    shape, specs = cases[name].get("move", cases[name]["place"])
    members = [r[name] for r in ranks[:int(np.prod(shape))]]
    split = 0
    for r in members:
        assert r["member"]
        for keys, leaf in _leaves(r["blocks"]):
            want = _at(whole, keys)
            if leaf is not None and isinstance(leaf, dict):
                split += 1
                (pos, block), = leaf["blocks"].items()
                assert pos == (r["coord"]["data"], r["coord"]["model"])
                cut = shard_slices(_at(specs, keys), want.shape, MESH[shape],
                                   r["coord"])
                assert leaf["shape"] == want.shape
                np.testing.assert_array_equal(block, want[cut])
                assert block.dtype == want.dtype
            else:  # replicated: the whole leaf on every rank
                np.testing.assert_array_equal(leaf, want)
            full = _at(r["full"], keys)
            assert full.dtype == want.dtype
            np.testing.assert_array_equal(full, want)
    assert split > 0
    for r in ranks[int(np.prod(shape)):]:  # off the mesh: nothing held
        assert not r[name]["member"]
        assert all(leaf is None for _, leaf in _leaves(r[name]["blocks"]))


def test_remesh_splits_what_the_specs_split(inputs):
    """The cases do split: experts and heads over ``model``, and a leaf
    over both axes, in both orders."""
    trees, cases = inputs
    specs = cases["model4"]["place"][1]["layers"]
    assert specs["moe"]["w_gate"] == (None, "model", None, None)
    assert specs["attn"]["wq"] == (None, None, "model", None)
    dense = cases["dense_four_to_two"]
    # 2 KV heads stay whole on 4 ranks and split over 2.
    assert dense["place"][1]["layers"]["attn"]["wk"] == ()
    assert dense["move"][1]["layers"]["attn"]["wk"] == (None, None, "model", None)
    assert dense["move"][1]["embed"] == ("model", None)
    grid = trees["grid"]["grid"]
    coord = {"data": 1, "model": 0}
    assert shard_slices(("data", "model", None), grid.shape, MESH[(2, 2)],
                        coord) == (slice(4, 8), slice(0, 6), slice(0, 5))
    assert shard_slices((("model", "data"), None, None), grid.shape,
                        MESH[(2, 2)], coord)[0] == slice(2, 4)
    assert shard_slices((("data", "model"), None, None), grid.shape,
                        MESH[(2, 2)], coord)[0] == slice(4, 6)
