"""The port's parameter, cache, batch and optimizer-state rules against the
reference planner's: for every full-size architecture (shapes only: the
reference's ``jax.eval_shape`` trees, the port's meta-device model and
caches), on both ``tests/test_sharding.py`` mesh shapes, with
``shard_head_dim_fallback`` and ``seq_parallel_decode`` on and off, the
specs (the reference's ``PartitionSpec``s as tuples) and the ``notes``
are equal.  Also the index grid of ``make_mesh_with_layout``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCHS, get_config as ref_config  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.sharding import planner as ref_planner  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import make_mesh_with_layout  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.sharding import planner  # noqa: E402

MESHES = {"pod": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
CACHE_SHAPES = [(128, 32768), (1, 4096)]  # decode_32k; a batch-1 decode


class FakeMesh:
    """Axis-size stub so planner rules can be tested without 256 devices."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def _plans(mesh_name, **kw):
    shape = MESHES[mesh_name]
    axes = tuple(a for a in shape if a != "model")
    return (ref_planner.ShardingPlan(mesh=FakeMesh(shape), batch_axes=axes, **kw),
            planner.ShardingPlan(mesh_shape=dict(shape), batch_axes=axes, **kw))


def _tuples(specs):
    return jax.tree.map(tuple, specs, is_leaf=lambda x: isinstance(x, P))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    rmodel = RefModel(ref_config(name))
    params = jax.eval_shape(lambda: rmodel.init(jax.random.PRNGKey(0)))
    model = Model(get_config(name), "meta")
    return name, rmodel, params, model


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("fallback", [False, True])
def test_param_and_opt_specs_equal_the_reference(arch, mesh_name, fallback):
    _, _, params, model = arch
    shapes = model.param_shapes()
    ref_plan, plan = _plans(mesh_name, shard_head_dim_fallback=fallback)
    assert planner.plan_params(plan, shapes) == _tuples(
        ref_planner.plan_params(ref_plan, params))
    assert plan.notes == ref_plan.notes
    for zero1 in (True, False):
        assert planner.plan_opt_state(plan, shapes, zero1) == _tuples(
            ref_planner.plan_opt_state(ref_plan, params, zero1))
        assert plan.notes == ref_plan.notes


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("seq_parallel", [True, False])
def test_cache_specs_equal_the_reference(arch, mesh_name, seq_parallel):
    _, rmodel, _, model = arch
    ref_plan, plan = _plans(mesh_name, seq_parallel_decode=seq_parallel)
    for batch, length in CACHE_SHAPES:
        rcaches = jax.eval_shape(lambda: rmodel.init_caches(batch, length))
        caches = model.init_caches(batch, length)  # meta tensors
        assert planner.plan_caches(plan, caches) == _tuples(
            ref_planner.plan_caches(ref_plan, rcaches))
    assert plan.notes == ref_plan.notes


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_specs_equal_the_reference(mesh_name):
    ref_plan, plan = _plans(mesh_name)
    for b, s in ((256, 4096), (32, 32768), (1, 1), (24, 16)):
        batch = {"tokens": (b, s), "labels": (b, s), "frontend": (b, 1500, 1024)}
        ref_batch = {k: jax.ShapeDtypeStruct(v, np.int32) for k, v in batch.items()}
        assert planner.plan_batch(plan, batch) == _tuples(
            ref_planner.plan_batch(ref_plan, ref_batch))
    assert plan.notes == ref_plan.notes
    assert plan.notes  # batch 1 and 24 do not divide


@pytest.mark.parametrize("multi_pod", [False, True])
def test_mesh_with_layout_places_each_logical_position(multi_pod):
    n = 512 if multi_pod else 256
    devices = [torch.device("cuda", i) for i in range(n)]
    order = np.random.default_rng(0).permutation(n)
    mesh = make_mesh_with_layout(order, multi_pod=multi_pod, devices=devices)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    assert mesh.devices.shape == shape
    assert tuple(mesh.shape.values()) == shape
    flat = mesh.devices.reshape(-1)
    assert all(flat[i] == devices[order[i]] for i in range(n))
    with pytest.raises(RuntimeError, match=f"need {n} devices"):
        make_mesh_with_layout(order, multi_pod=multi_pod, devices=devices[:n - 1])
