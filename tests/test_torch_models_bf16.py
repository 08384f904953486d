"""The port's model zoo against the reference's in bf16 (the
``tests/test_dtype_bf16.py`` cases) for the dense, MoE and VLM
architectures at their reduced size; the hybrid, SSM and audio ones are in
``test_torch_models_bf16_mixers.py``.

The weights are the reference's own init (``init_params`` at
PRNGKey(0), carried over by ``interop.model_params_from``; a bf16 init is
the f32 one cast, as ``init_dense`` casts its f32 draw), and the
reference runs eagerly, as ``test_dtype_bf16.py`` runs it: jitted, XLA
rounds bf16 elsewhere, and DeepSeek-V2-Lite's jitted forward differs from
its eager one by 0.26 * max|logit| where a router near-tie flips an
expert choice.  Such a flip between two valid roundings is a property of
bf16 routing that no elementwise bound covers; the router itself is held
exactly, ties included, in ``test_torch_models.py``.

Train, prefill and decode keep bf16, have no NaN, and are within
5e-2 * max|ref| of the reference, caches too: wider than f32 because
XLA and eager torch round to bf16 at different points."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCHS, get_config  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from test_torch_models import configs, flat, rel, run_both  # noqa: E402

BF16_TOL = 5e-2
MIXERS = ("hybrid", "ssm", "audio")  # test_torch_models_bf16_mixers.py


def bf16_reference_run(name):
    rcfg, _ = configs(name, "float32")
    rcfg16, _ = configs(name, "bfloat16")
    key = jax.random.PRNGKey(0)
    params = jax.jit(RefModel(rcfg).init)(key)
    dtypes = jax.eval_shape(RefModel(rcfg16).init, key)
    tree = jax.tree.map(lambda a, d: np.asarray(a.astype(d.dtype)), params, dtypes)
    return run_both(name, "bfloat16", tree, eager=True)


def check_logits(run, mode):
    cfg, ref, got = run
    assert got[mode].dtype == torch.bfloat16
    assert not bool(torch.isnan(got[mode].float()).any())
    assert rel(ref[mode], got[mode]) < BF16_TOL, cfg.name


def check_caches(run, stage):
    cfg, ref, got = run
    ref_c = flat(ref[stage])
    assert set(ref_c) == set(got[stage])
    for key, r in ref_c.items():
        g = got[stage][key]
        assert g.dtype == (torch.int32 if key[-1] == "pos" else
                           torch.float32 if key[-1] == "state" else
                           torch.bfloat16), key
        if key[-1] == "pos":
            np.testing.assert_array_equal(g.numpy(), r, err_msg=str(key))
        else:
            assert rel(r, g) < BF16_TOL, (cfg.name, key)


@pytest.fixture(scope="module",
                params=[n for n in ARCHS if get_config(n).family not in MIXERS])
def bf16_run(request):
    return bf16_reference_run(request.param)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_bf16_logits_keep_dtype_and_match_reference(bf16_run, mode):
    check_logits(bf16_run, mode)


@pytest.mark.parametrize("stage", ["prefill_caches", "decode_caches"])
def test_bf16_caches_keep_dtype_and_match_reference(bf16_run, stage):
    check_caches(bf16_run, stage)
