"""The port's roofline (`repro_torch.launch.roofline`) and op counter
(`repro_torch.launch.op_analysis`): ``truncate_config``, ``_units_of`` and
``model_flops`` against the reference's; ``roofline_terms`` on hand-set
counters; and, for a reduced config of each family (dense, MoE, MLA, SSM,
hybrid, VLM, audio) in train, prefill and decode, the counts taken on the
meta device equal the counts of the same step run on the CPU, and FLOPs
and bytes are exactly linear in units 1-3.  The reduced llama forward's
matmul FLOPs equal a closed form of its config."""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import ARCHS, get_config as ref_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.dryrun import cell_step, count_cell  # noqa: E402
from repro_torch.launch.op_analysis import count_ops, op_census  # noqa: E402
from repro_torch.models import Model, build_model  # noqa: E402

FAMILIES = {"dense": "llama3-8b", "moe": "qwen3-moe-30b-a3b",
            "mla": "deepseek-v2-lite-16b", "ssm": "mamba2-780m",
            "hybrid": "hymba-1.5b", "vlm": "llama-3.2-vision-11b",
            "audio": "whisper-medium"}
KINDS = ("train", "prefill", "decode")
SMALL = {kind: ShapeSpec(f"small_{kind}", 16, 2, kind) for kind in KINDS}
# Keys of a count that differ between devices by construction: the CPU makes
# no host-to-device copies, and the wall clock is the host's.
NOT_COMPARED = ("host_copies", "host_bytes", "count_s")


def _reference_roofline():
    """The reference's roofline module, imported without its device-count
    XLA flag reaching this process's environment."""
    saved = os.environ.get("XLA_FLAGS")
    os.environ["DRYRUN_XLA_FLAGS"] = saved or ""
    try:
        import repro.launch.roofline as ref
    finally:
        os.environ.pop("DRYRUN_XLA_FLAGS")
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


REF = _reference_roofline()


@pytest.mark.parametrize("arch", ARCHS)
def test_truncation_units_and_model_flops_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert roofline._units_of(cfg) == REF._units_of(rcfg)
    for units in (1, 2, 3, 4):
        assert dataclasses.asdict(roofline.truncate_config(cfg, units)) == \
            dataclasses.asdict(REF.truncate_config(rcfg, units))
    for shape in SHAPES:
        assert roofline.model_flops(cfg, shape) == REF.model_flops(rcfg, shape)


def test_roofline_terms_on_hand_set_counters():
    c = {"flops_matmul:bfloat16": 989.4e12, "flops_matmul:float32": 67e12,
         "flops_pointwise": 67e12, "bytes": 5 * 3.35e12, "flops": 0}
    t = roofline.roofline_terms(c)
    assert t["compute_s"] == pytest.approx(3.0, rel=1e-12)
    assert t["memory_s"] == pytest.approx(5.0, rel=1e-12)
    assert (t["collective_s"], t["dominant"], t["coll_bytes"]) == (0.0, "memory_s", 0)
    assert t["bound_s"] == t["memory_s"]
    half = roofline.roofline_terms({**c, "bytes": 3.35e12}, chips=2)
    assert half["compute_s"] == pytest.approx(1.5, rel=1e-12)
    assert (half["dominant"], half["bound_s"]) == ("compute_s", half["compute_s"])
    # Per-chip collectives: their bytes over NVLink's 450 GB/s, never
    # divided by chips.
    coll = {**c, "coll:all-reduce": 4 * 450e9, "coll:all-gather": 2 * 450e9}
    t = roofline.roofline_terms(coll)
    assert t["collective_s"] == pytest.approx(6.0, rel=1e-12)
    assert (t["dominant"], t["bound_s"], t["coll_bytes"]) == (
        "collective_s", t["collective_s"], 6 * 450e9)
    assert roofline.roofline_terms(coll, chips=2)["collective_s"] == t["collective_s"]
    assert roofline.H100_NVLINK_BYTES_PER_S == 450e9
    with pytest.raises(ValueError, match="int8"):
        roofline.roofline_terms({"flops_matmul:int8": 1.0})
    with pytest.raises(ValueError, match="chips"):
        roofline.roofline_terms(c, chips=0)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("kind", KINDS)
def test_meta_counts_equal_cpu_counts(family, kind):
    cfg = get_config(FAMILIES[family]).reduced()
    meta = count_cell(cfg, SMALL[kind])
    model = build_model(cfg, "cpu", seed=0)
    call, _ = cell_step(cfg, SMALL[kind], model,
                        generator=torch.Generator().manual_seed(0))
    _, cpu = count_ops(call)
    assert cpu["host_copies"] == 0
    assert meta["flops_matmul"] > 0 and meta["bytes accessed"] > 0
    for key in cpu:
        if key not in NOT_COMPARED:
            assert meta[key] == cpu[key], key
    assert op_census(meta)["dot"] == sum(
        meta["ops"].get(k, 0) for k in ("mm", "addmm", "bmm", "baddbmm"))


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("kind", KINDS)
def test_counts_are_exactly_linear_in_units(family, kind):
    cfg = get_config(FAMILIES[family]).reduced()
    v = [roofline._counters(count_cell(roofline.truncate_config(cfg, n), SMALL[kind]))
         for n in (1, 2, 3)]
    for key in ("flops", "bytes", "flops_pointwise"):
        assert v[1][key] - v[0][key] == v[2][key] - v[1][key] > 0, key


def test_measure_cell_extrapolates_to_the_full_count():
    cfg = get_config("llama3-8b").reduced()
    full = roofline._units_of(cfg)
    rec = roofline.measure_cell(cfg, SMALL["train"], n1=1, n2=2, verbose=False)
    assert rec["status"] == "ok" and (rec["n1"], rec["n2"], rec["units"]) == (1, 2, full)
    assert rec["linear_gap"] == {"flops": 0.0, "bytes": 0.0}
    assert rec["counters"] == rec["full_counters"]
    assert set(rec["depths"]) == {"1", "2", str(full)}


def test_reduced_llama_forward_matmul_flops_closed_form():
    cfg = get_config("llama3-8b").reduced()
    b, s = 2, 48
    kv_chunk = 32  # two chunks, the second half padding
    model = Model(cfg, "meta")
    tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
    _, rec = count_ops(lambda: model(tokens, mode="train", kv_chunk=kv_chunk))
    d, h, kvh, hd, f = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    s_pad = -(-s // kv_chunk) * kv_chunk
    per_layer = (2 * b * s * d * (h + 2 * kvh) * hd  # q, k, v
                 + 2 * b * s * h * hd * d  # o
                 + 2 * 2 * b * s * h * hd * s_pad  # scores and P.V, every chunk
                 + 3 * 2 * b * s * d * f)  # gate, up, down
    want = cfg.num_layers * per_layer + 2 * b * s * d * cfg.vocab_size
    assert rec["flops_matmul_by_dtype"] == {"float32": want}


def test_measure_cell_extrapolates_the_collectives_per_chip():
    """Per chip at a (1, 2) position (a counting mesh): the ``coll:*``
    counters extrapolate from 1 and 2 layers to the full depth's count,
    exactly, and give the collective term."""
    from repro_torch.launch.mesh import make_counting_mesh

    cfg = get_config("llama3-8b").reduced()
    rec = roofline.measure_cell(cfg, SMALL["train"], n1=1, n2=2, verbose=False,
                                mesh=make_counting_mesh((1, 2)))
    assert rec["status"] == "ok" and rec["partitioned"]
    assert rec["counters"] == rec["full_counters"]
    c = rec["counters"]
    assert c["coll:all-reduce"] > 0 and c["coll:all-gather"] > 0
    terms = roofline.roofline_terms(c)
    assert terms["coll_bytes"] == c["coll:all-reduce"] + c["coll:all-gather"]
    assert terms["collective_s"] == terms["coll_bytes"] / 450e9


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_per_chip_ratio_and_fraction_count_every_chip(kind, shape):
    """A per-chip record's ``useful_ratio`` sets the whole batch's 6ND
    against its count times its ``chips``: on a reduced llama, whose
    heads split over ``model``, it reads as the unsharded record's within
    the work the positions repeat (norms, replicated leaves' updates), not
    ``chips`` times it, and its ``bound_mfu`` stays below 1."""
    from repro_torch.launch.mesh import make_counting_mesh

    cfg = get_config("llama3-8b").reduced()
    sp = ShapeSpec(f"small_{kind}", 16, 4, kind)
    mf = roofline.model_flops(cfg, sp)
    one = roofline.measure_cell(cfg, sp, n1=1, n2=2, verbose=False, full=False)
    part = roofline.measure_cell(cfg, sp, n1=1, n2=2, verbose=False, full=False,
                                 mesh=make_counting_mesh(shape))
    assert (one["chips"], part["chips"]) == (1, shape[0] * shape[1])
    whole = roofline.useful_ratio(one, mf)
    assert 0.5 < whole <= 1.0
    assert roofline.useful_ratio(part, mf) == pytest.approx(whole, rel=0.1)
    for rec in (one, part):
        frac = roofline.bound_mfu(rec, mf, roofline.roofline_terms(rec["counters"]))
        assert 0.0 < frac <= 1.0
