"""The MoE's expert counts: ``moe._bincount`` (an integer ``index_add_``,
which has a meta kernel) gives what ``torch.bincount`` gave, so
``router_topk``'s aux loss and ``_dispatch_combine``'s slots and output
are bitwise unchanged on the CPU; and the MoE train, prefill and serve
steps run on the meta device."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.launch.dryrun import count_cell  # noqa: E402
from repro_torch.models import moe  # noqa: E402


def _torch_bincount(ids, n):
    return torch.bincount(ids, minlength=n)


def _case(seed: int, t: int = 96, e: int = 8, d: int = 16, f: int = 24):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((t, d)), dtype=torch.float32)
    logits = torch.tensor(rng.standard_normal((t, e)), dtype=torch.float32)
    w = [torch.tensor(rng.standard_normal(s) / 4, dtype=torch.float32)
         for s in ((e, d, f), (e, d, f), (e, f, d))]
    return x, logits, w


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("top_k,capacity,e_start", [(2, 20, 0), (1, 6, 0), (2, 9, 2)])
def test_counts_aux_slots_and_output_bitwise_as_with_bincount(
        monkeypatch, seed, top_k, capacity, e_start):
    x, logits, (w_gate, w_up, w_down) = _case(seed)
    w_loc = (w_gate[:5], w_up[:5], w_down[:5]) if e_start else (w_gate, w_up, w_down)
    ids = torch.tensor(np.random.default_rng(seed).integers(0, 11, 300))
    assert torch.equal(moe._bincount(ids, 11), torch.bincount(ids, minlength=11))
    assert moe._bincount(ids, 11).dtype == torch.int64

    slots = {}
    real_where = torch.where

    def spy_where(cond, a, b):  # the slot tensor is the where over se*cap+rank
        out = real_where(cond, a, b)
        if isinstance(b, torch.Tensor) and b.dtype == torch.int64 and b.dim() == 1:
            slots.setdefault(len(slots), out)
        return out

    def run():
        slots.clear()
        weights, experts, aux = moe.router_topk(logits, top_k)
        with monkeypatch.context() as m:
            m.setattr(moe.torch, "where", spy_where)
            out = moe._dispatch_combine(x, weights, experts, *w_loc, e_start, capacity)
        return weights, experts, aux, out, list(slots.values())

    new = run()
    monkeypatch.setattr(moe, "_bincount", _torch_bincount)
    old = run()
    assert all(torch.equal(a, b) for a, b in zip(new[:4], old[:4]))
    assert len(new[4]) == len(old[4]) >= 1
    assert all(torch.equal(a, b) for a, b in zip(new[4], old[4]))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_moe_steps_run_on_meta(arch, kind):
    cfg = get_config(arch).reduced()
    rec = count_cell(cfg, ShapeSpec(f"meta_{kind}", 16, 2, kind))
    assert rec["ops"]["index_add_"] >= 1 and "bincount" not in rec["ops"]
    assert rec["flops_matmul"] > 0
