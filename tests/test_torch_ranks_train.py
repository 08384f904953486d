"""Training on gloo rank meshes against the port's unsharded train step.

`make_train_step` on (data, model) rank meshes (`run_ranks`, 4 CPU ranks,
one job; bodies in `torch_ranks_bodies.train`), each rank's model built
from seed 0 for its position, two steps on the same global batches as the
unsharded step of the model from the same seed:

* a reduced llama3-8b (2 layers, f32; 4 heads, 2 KV heads, vocab 512) on
  (1, 2) (tensor parallel), (2, 1) (data parallel) and (2, 2), with ZeRO-1
  on and off, on (1, 4) (the 2 KV heads stay whole: ``wk``/``wv``'s
  gradients are summed over ``model``), and with remat under both
  policies;
* a reduced qwen3-moe-30b-a3b (2 layers, E = 8, top-2, f32; qk-norm) on
  (1, 2) (expert and tensor parallel) and (2, 2) with ZeRO-1.  On (2, 2)
  each data rank's load-balance loss is of its own rows and the two are
  averaged (the reference's ``pmean``), so the unsharded side sums the
  gradients of the two row blocks' losses, halved.

Bounds: every rank reports the unsharded loss and gradient norm within
rtol 1e-6, and each rank's moments, as blocks of the stacked whole leaf
(`torch_ranks_bodies.moment_blocks`; the router's and the experts'
included), are within 5e-6 of that leaf's max|·| of the unsharded
moments after the first step: the sharded program sums in another
order, and the gradients agree to ~2e-6 of their max (measured at most
1.8e-6).  A missing sum over ``model`` or a gradient counted twice moves
a leaf's moments by its whole size.  After the second step the moments
are held within 1e-4 and each rank's parameters to the unsharded
parameters' blocks within 5e-2 of the largest change the unsharded steps
made to that leaf: Adam's normalised update turns a gradient near its
``eps`` into a step of either sign (one step's parameters drift by up
to 1.8e-2 of a leaf's change; the drift rule is
tests/test_torch_train.py's), and the second step's gradients are taken
there (up to 2.8e-5).

Remat is held bitwise to the run without it, and the collectives' tally
shows what ``"save_collectives"`` keeps: it issues exactly what the run
without remat issues, while ``"full"`` issues again each collective that
comes before a layer's last saved tensor (early stop ends the
recomputation there): a dense layer's two row-parallel sums (the MLP's
product saves its operands once it has summed), a MoE layer's
attention sum (its experts' sum and load-balance means come after the
combine's last saved tensor)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks_bodies as bodies  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import reference_opt_state  # noqa: E402
from repro_torch.launch import make_local_mesh  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw_update  # noqa: E402

LAYERS = 2
BATCH, SEQ = 4, 16
METRIC_RTOL = 1e-6
MOMENT_TOLS = (5e-6, 1e-4)  # of the leaf's max|moment|, after steps 1 and 2
DRIFT = 5e-2  # of the leaf's largest change, after step 2

# name -> (arch, shape, zero1, remat, policy)
CASES = {
    "llama_1x2": ("llama3-8b", (1, 2), False, False, "full"),
    "llama_1x2_zero1": ("llama3-8b", (1, 2), True, False, "full"),
    "llama_2x1": ("llama3-8b", (2, 1), False, False, "full"),
    "llama_2x1_zero1": ("llama3-8b", (2, 1), True, False, "full"),
    "llama_2x2": ("llama3-8b", (2, 2), False, False, "full"),
    "llama_2x2_zero1": ("llama3-8b", (2, 2), True, False, "full"),
    "llama_1x4": ("llama3-8b", (1, 4), False, False, "full"),
    "llama_1x2_remat_full": ("llama3-8b", (1, 2), False, True, "full"),
    "llama_1x2_remat_save": ("llama3-8b", (1, 2), False, True,
                             "save_collectives"),
    "moe_1x2": ("qwen3-moe-30b-a3b", (1, 2), False, False, "full"),
    "moe_2x2_zero1": ("qwen3-moe-30b-a3b", (2, 2), True, False, "full"),
    "moe_1x2_remat_full": ("qwen3-moe-30b-a3b", (1, 2), False, True, "full"),
    "moe_1x2_remat_save": ("qwen3-moe-30b-a3b", (1, 2), False, True,
                           "save_collectives"),
}
PARITY = [name for name in CASES if "remat" not in name]


def _cfg(arch):
    return dataclasses.replace(get_config(arch).reduced(), num_layers=LAYERS)


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32) for _ in range(2)]


@pytest.fixture(scope="module")
def ranks(batches, tmp_path_factory):
    """Every case's results, by case, as a list over the ranks that hold a
    position of its mesh."""
    out = {name: [] for name in CASES}
    for arch in ("llama3-8b", "qwen3-moe-30b-a3b"):
        cases = {name: dict(shape=shape, zero1=zero1, remat=remat, policy=policy)
                 for name, (a, shape, zero1, remat, policy) in CASES.items()
                 if a == arch}
        got = run_ranks(bodies.train, 4, tmp_path_factory.mktemp(arch),
                        _cfg(arch), batches, cases, device="cpu")
        for r in got:
            for name, res in r.items():
                out[name].append(res)
    return out


def _unsharded(arch, batches, blocks: int) -> dict:
    """Two steps of the unsharded model from seed 0: each step's metrics
    and stacked moments, the parameters after them and at the start.
    With ``blocks`` > 1 each step's gradient is the mean of the row
    blocks' losses'."""
    cfg = _cfg(arch)
    model = build_model(cfg, "cpu", seed=0)
    start = {n: p.detach().clone().numpy() for n, p in model.named_parameters()}
    bundle = make_train_step(cfg, make_local_mesh(device="cpu"),
                             opt=bodies.TRAIN_OPT, remat=False, zero1=False)
    state, step = bundle.init_opt(model), bundle.jit_for(None)
    metrics, moments = [], []
    for tokens in batches:
        tokens = torch.from_numpy(tokens)
        if blocks == 1:
            state, m = step(model, state, {"tokens": tokens})
        else:
            model.requires_grad_(True)
            losses = []
            for rows in tokens.chunk(blocks):
                loss, _ = model.loss({"tokens": rows})
                (loss / blocks).backward()
                losses.append(loss.detach())
            grads = {n: p.grad for n, p in model.named_parameters()}
            m = adamw_update(model, grads, state, bodies.TRAIN_OPT)
            m["loss"] = torch.stack(losses).mean()
            model.zero_grad(set_to_none=True)
        metrics.append({k: float(v) for k, v in m.items()})
        ref = reference_opt_state(model, state)
        moments.append({part: dict(_flat(ref[part])) for part in ("m", "v")})
    return dict(metrics=metrics, moments=moments, start=start,
                params={n: p.detach().numpy() for n, p in model.named_parameters()})


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


@pytest.fixture(scope="module")
def unsharded(batches):
    return {("llama3-8b", 1): _unsharded("llama3-8b", batches, 1),
            ("qwen3-moe-30b-a3b", 1): _unsharded("qwen3-moe-30b-a3b", batches, 1),
            ("qwen3-moe-30b-a3b", 2): _unsharded("qwen3-moe-30b-a3b", batches, 2)}


def _want(name, unsharded):
    arch, shape = CASES[name][:2]
    blocks = shape[0] if arch.startswith("qwen3-moe") else 1
    return unsharded[arch, blocks]


@pytest.mark.parametrize("name", PARITY)
def test_rank_training_matches_the_unsharded_step(ranks, unsharded, name):
    want = _want(name, unsharded)
    shape = CASES[name][1]
    members = ranks[name]
    assert len(members) == shape[0] * shape[1]
    for r in members:
        for got, ref in zip(r["metrics"], want["metrics"]):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(got[k], ref[k], rtol=METRIC_RTOL,
                                           err_msg=k)
        for tol, got, ref in zip(MOMENT_TOLS, r["moments"], want["moments"]):
            for part in ("m", "v"):
                assert sorted(got[part]) == sorted(ref[part])
                for path, block in r["moment_blocks"].items():
                    whole = ref[part][path]
                    err = np.abs(got[part][path] - whole[block]).max()
                    assert err <= tol * np.abs(whole).max(), (part, path, err)
        for n, p in r["params"].items():
            block = r["blocks"][n][1] if n in r["blocks"] else ...
            moved = np.abs(want["params"][n] - want["start"][n]).max()
            assert p.shape == want["params"][n][block].shape, n
            assert np.abs(p - want["params"][n][block]).max() <= DRIFT * moved, n


@pytest.mark.parametrize("name", ["llama_2x2_zero1", "moe_2x2_zero1"])
def test_zero1_cuts_the_moments_over_the_data_axis(ranks, name):
    """ZeRO-1's moments (`plan_opt_state`'s rule on what the rank holds):
    the two data ranks of one model coordinate hold disjoint halves of
    the leaf's model block along one dimension, which together cover it,
    and the same parameters, bit for bit.  Only the 0-d and odd-sized
    leaves stay whole (none here)."""
    by_model = {}
    for r in ranks[name]:
        by_model.setdefault(r["coord"]["model"], []).append(r)
    for a, b in by_model.values():
        assert (a["coord"]["data"], b["coord"]["data"]) == (0, 1)
        for path, block in a["moment_blocks"].items():
            other = b["moment_blocks"][path]
            cut = [d for d, (x, y) in enumerate(zip(block, other)) if x != y]
            assert len(cut) == 1, path
            d = cut[0]
            assert block[d].stop == other[d].start, path
            assert a["moments"][-1]["m"][path].shape[d] * 2 == \
                block[d].stop - block[d].start + other[d].stop - other[d].start
        for n in a["params"]:
            np.testing.assert_array_equal(a["params"][n], b["params"][n])


@pytest.mark.parametrize("arch", ["llama", "moe"])
def test_remat_policies_give_the_same_values(ranks, arch):
    """Remat under either policy: the same metrics, parameters and
    moments as without remat, bitwise."""
    base = ranks[f"{arch}_1x2"]
    for policy in ("full", "save"):
        for got, want in zip(ranks[f"{arch}_1x2_remat_{policy}"], base):
            assert got["coord"] == want["coord"]
            assert got["metrics"] == want["metrics"]
            for k in want["params"]:
                np.testing.assert_array_equal(got["params"][k], want["params"][k])
            for g, w in zip(got["moments"], want["moments"]):
                for part in ("m", "v"):
                    for k in w[part]:
                        np.testing.assert_array_equal(g[part][k], w[part][k])


@pytest.mark.parametrize("arch, again", [("llama", 2), ("moe", 1)])
def test_save_collectives_issues_no_collective_again(ranks, arch, again):
    """The tally of a train step: ``"save_collectives"`` issues what the
    run without remat issues; ``"full"`` issues ``again`` more all_reduces
    a layer, of the layer's activations (see the module docstring)."""
    act = BATCH * SEQ * 128 * 4
    plain = ranks[f"{arch}_1x2"][0]["tallies"]
    save = ranks[f"{arch}_1x2_remat_save"][0]["tallies"]
    full = ranks[f"{arch}_1x2_remat_full"][0]["tallies"]
    for p, s, f in zip(plain, save, full):
        assert s == p
        assert f["count"]["all-reduce"] == p["count"]["all-reduce"] + again * LAYERS
        assert f["bytes"]["all-reduce"] == \
            p["bytes"]["all-reduce"] + again * LAYERS * act
        assert f["count"]["all-gather"] == p["count"]["all-gather"]


def test_llama_train_step_tally(ranks):
    """A tensor-parallel (1, 2) train step of the dense model: forward
    2L + 2 (the embedding's sum, each layer's two row-parallel sums, the
    head's gather); backward 2L + 1 copies' sums (each layer's attention
    and MLP inputs, the head's input); the optimizer's norm over
    ``model``: 4L + 4 in all, the row-parallel sums in f32."""
    d, vocab = 128, 512
    for r in ranks["llama_1x2"]:
        for tally in r["tallies"]:
            assert tally["count"] == {"all-reduce": 4 * LAYERS + 3,
                                      "all-gather": 1, "_count": 4 * LAYERS + 4}
            act = BATCH * SEQ * d * 4
            assert tally["bytes"] == {
                "all-reduce": (4 * LAYERS + 2) * act + 4,
                "all-gather": BATCH * SEQ * (vocab // 2) * 4,
                "_count": 4 * LAYERS + 4}
            assert tally["bytes_by_dtype"]["all-reduce:float32"] == \
                tally["bytes"]["all-reduce"]


LOOP = dict(steps=4, batch=4, seq=16, lr=1e-2)


def test_train_loop_on_a_data_parallel_mesh(tmp_path):
    """`train_loop` on a (2, 1) mesh of two ranks: both log the same
    losses, those of the unsharded loop within rtol 1e-5 (four steps'
    drift, as tests/test_torch_train.py bounds five); stopped after two
    steps with a checkpoint that rank 0 writes and resumed by both, they
    are the straight run's, bitwise.  On (1, 2), where the ranks hold
    blocks, the same: the checkpoint gathers them and each rank cuts its
    own back, and the resumed losses are the straight run's, bitwise."""
    cfg = _cfg("llama3-8b")
    got = run_ranks(bodies.train_loops, 2, tmp_path, cfg, str(tmp_path), LOOP,
                    device="cpu")
    want = train_loop(cfg, make_local_mesh(device="cpu"),
                      print_fn=lambda *_: None, **LOOP)["losses"]
    for shape in ((2, 1), (1, 2)):
        assert got[0][shape]["straight"] == got[1][shape]["straight"]
        np.testing.assert_allclose(got[0][shape]["straight"], want, rtol=1e-5)
        for r in got:
            assert r[shape]["resumed"] == r[shape]["straight"]
