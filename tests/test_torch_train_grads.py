"""The port's loss and gradients against the reference's
``jax.value_and_grad(Model.loss)`` (eager, unsharded), every architecture
at its reduced size cut to two layers, in f32, on the same weights
(``interop.model_params_from``; the reference's init with every leaf it
initializes to a constant perturbed, so that norm scales and the VLM's
cross gates act) and the same numpy-seeded batch (a frontend for
vlm/audio): the loss within 1e-6 relative, each gradient leaf within
1e-5 of that leaf's max|grad| (bounds named per leaf below where the
reference itself is less stable), and ``remat=True`` bitwise equal to
``remat=False`` in the port.  The architectures are split over this file
and ``test_torch_train_grads_b.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, get_config as ref_config  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import model_params_from, reference_tree  # noqa: E402

LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5  # of the leaf's max|grad|
# Leaves held to a wider bound, each with the error measured on the CPU
# (port against the eager reference, of max|grad|).  Hymba's Mamba decay
# parameters: their gradients sum terms of both signs through exp(segsum)
# and the three-operand einsums, whose contraction order (opt_einsum's
# path in each package) decides the last bits; the reference's jitted
# gradient differs from its own eager one by 8.9e-6 (swa a_log), 5.0e-6
# (global a_log) and 3.9e-6 (swa dt_bias) on the same leaves.
LEAF_TOL = {("hymba-1.5b", ("swa", "mamba", "a_log")): 3e-5,  # measured 2.10e-5
            ("hymba-1.5b", ("global", "mamba", "a_log")): 3e-5,  # 1.53e-5
            ("hymba-1.5b", ("swa", "mamba", "dt_bias")): 2e-5}  # 1.28e-5
_CONSTANT_LEAVES = {"attn_norm", "mlp_norm", "attn_out_norm", "ssm_out_norm",
                    "self_norm", "cross_norm", "pre_norm", "final_norm",
                    "enc_norm", "q_norm", "k_norm", "norm", "d_skip",
                    "dt_bias", "a_log", "gate_attn", "gate_mlp"}
NAMES = ARCHS[:5]


def two_layers(cfg):
    """``cfg`` cut to two layers: Hymba keeps one global-attention layer
    and one SWA layer, the VLM one self-attention and one cross layer."""
    kw = {"num_layers": 2}
    if cfg.family == "hybrid":
        kw["global_attn_layers"] = (0,)
    if cfg.family == "vlm":
        kw["cross_attn_every"] = 1
    return dataclasses.replace(cfg, **kw)


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def case(name):
    """(reference config, port config, weights as numpy, batch as numpy)."""
    rcfg = two_layers(ref_config(name).reduced())
    cfg = two_layers(get_config(name).reduced())
    params = jax.tree.map(np.asarray, RefModel(rcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
                         if path[-1].key in _CONSTANT_LEAVES else a), params)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)}
    if cfg.family in ("vlm", "audio"):
        batch["frontend"] = rng.standard_normal(
            (2, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)
    return rcfg, cfg, params, batch


def port_grads(cfg, params, batch, remat: bool):
    """(loss, {parameter name: grad, zeros where the loss does not reach
    the parameter}) of the port on the CPU."""
    model = model_params_from(cfg, params, device="cpu")
    model.requires_grad_(True)
    loss, _ = model.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                         remat=remat)
    loss.backward()
    return model, loss.detach(), {
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in model.named_parameters()}


def check_against_reference(name):
    rcfg, cfg, params, batch = case(name)
    rmodel = RefModel(rcfg)
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: rmodel.loss(p, jax.tree.map(jnp.asarray, batch)), has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    model, loss, grads = port_grads(cfg, params, batch, remat=False)
    assert abs(float(loss) - float(rloss)) <= LOSS_RTOL * abs(float(rloss)), (
        name, float(loss), float(rloss))
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(grads[n])
    got, want = flat(reference_tree(model)), flat(jax.tree.map(np.asarray, rgrads))
    assert set(got) == set(want)
    errors = {}
    for key, w in want.items():
        scale = float(np.abs(w).max())
        err = float(np.abs(got[key].numpy() - w).max())
        tol = LEAF_TOL.get((name, key), GRAD_TOL)
        if err > tol * scale:
            errors["/".join(key)] = err / scale
    assert not errors, f"{name}: gradient error / max|grad| {errors}"


def check_remat_bitwise(name):
    _, cfg, params, batch = case(name)
    _, loss, grads = port_grads(cfg, params, batch, remat=False)
    _, loss_r, grads_r = port_grads(cfg, params, batch, remat=True)
    assert torch.equal(loss, loss_r)
    assert all(torch.equal(grads[n], grads_r[n]) for n in grads)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_the_reference(name):
    check_against_reference(name)


@pytest.mark.parametrize("name", NAMES)
def test_remat_is_bitwise_equal_to_no_remat(name):
    check_remat_bitwise(name)
