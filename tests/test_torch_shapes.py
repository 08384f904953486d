"""The port's input-shape registry against the reference's
(`repro.configs.shapes`): for every architecture x shape, ``applicable``
and its reason, ``input_specs`` (meta tensors against the reference's
``ShapeDtypeStruct``s) and ``cache_specs`` (the port's meta cache tree
against the reference's ``jax.eval_shape`` tree), shapes and dtypes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCHS, get_config as ref_config  # noqa: E402
from repro.configs import shapes as ref_shapes  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402

CELLS = [(a, s) for a in ARCHS for s in ref_shapes.SHAPES]


def _dtype(d) -> str:
    return str(d).removeprefix("torch.") if isinstance(d, torch.dtype) \
        else np.dtype(d).name


def _tree(node) -> dict:
    """{path: (shape, dtype name)} of a nested dict of arrays or tensors."""
    if isinstance(node, dict):
        return {(k,) + p: v for k in sorted(node) for p, v in _tree(node[k]).items()}
    return {(): (tuple(node.shape), _dtype(node.dtype))}


def test_shape_registry_is_the_reference_s():
    assert list(shapes.SHAPES) == list(ref_shapes.SHAPES)
    for name, sp in shapes.SHAPES.items():
        ref = ref_shapes.SHAPES[name]
        assert (sp.name, sp.seq_len, sp.global_batch, sp.kind) == (
            ref.name, ref.seq_len, ref.global_batch, ref.kind)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_applicable_input_and_cache_specs_equal_the_reference(arch, shape):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert shapes.applicable(cfg, shape) == ref_shapes.applicable(rcfg, shape)
    got = shapes.input_specs(cfg, shape)
    assert all(t.device.type == "meta" for t in got.values())
    assert _tree(got) == _tree(ref_shapes.input_specs(rcfg, shape))
    caches = shapes.cache_specs(cfg, shape)
    assert _tree(caches) == _tree(ref_shapes.cache_specs(rcfg, shape))
