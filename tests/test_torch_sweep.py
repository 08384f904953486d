"""The port's sweep driver (`repro_torch.launch.sweep`) and its batched
population SA against the reference and against sequential port runs on
the CPU: the grid, the Pareto flags and the sharing keys as the
reference's; host-mapper rows bitwise the reference's rows; each element
of `sa_search_jax_batch` bitwise the single `sa_search_jax` call; every
row bitwise the matching single `run_toolchain` call."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ToolchainConfig as RefConfig  # noqa: E402
from repro.launch import sweep as ref_sweep  # noqa: E402
from repro.snn import make_snn, profile_snn  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import ToolchainConfig, phase_seeds, run_toolchain  # noqa: E402
from repro_torch.core import mapping_device as md  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    SweepResult,
    config_grid,
    pareto_flags,
    run_sweep,
)

FAST = {"iters": 800}
DROP = ("partition_s", "mapping_s", "evaluate_s", "total_s", "pareto")


def _stats(row: dict) -> dict:
    return {k: v for k, v in row.items() if k not in DROP}


@pytest.fixture(scope="module")
def ref_profile():
    return profile_snn(make_snn("smooth_320"), num_steps=200, seed=0)


@pytest.fixture(scope="module")
def profile(ref_profile):
    return interop.profile_from(ref_profile)


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out.pop("device", None)
    return out


# ------------------------------------------------------------------- grid
GRIDS = [
    dict(mesh=[(4, 4), (8, 8)], seed=[0, 1], mapper="sa",
         score_backend=["numpy"], stepper=["jax"]),
    dict(method=["sneap", "spinemap", "sco"], objective=["cut", "volume"],
         capacity=64, mapper_kwargs={"iters": 40}, screen="linkload"),
    dict(seed=[0, 1], mapper="sa_jax", knobs=[{"_KERNEL_MAX_N": 0}, {}],
         noc_kwargs={"engine": "ref"}),
]


@pytest.mark.parametrize("axes", GRIDS)
def test_config_grid_matches_reference(axes):
    got = config_grid(**axes)
    want = ref_sweep.config_grid(**axes)
    assert [_fields(c) for c in got] == [_fields(c) for c in want]
    assert all(c.device == "cuda" for c in got)


def test_config_grid_axes():
    grid = config_grid(mesh=[(4, 4), (8, 8)], seed=[0, 1], mapper="sa",
                       score_backend=["numpy"], stepper=["jax"],
                       device="cpu")
    assert len(grid) == 4
    assert {(c.mesh_w, c.mesh_h) for c in grid} == {(4, 4), (8, 8)}
    assert all(c.mapper_kwargs == {"score_backend": "numpy"} for c in grid)
    assert all(c.noc_kwargs == {"stepper": "jax"} for c in grid)
    assert all(c.device == "cpu" for c in grid)
    with pytest.raises(ValueError, match="unknown sweep axis"):
        config_grid(mesh_width=[4])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pareto_flags_match_reference(seed):
    rng = np.random.default_rng(seed)
    rows = [{"energy_pj": float(rng.integers(0, 5)),
             "avg_latency": float(rng.integers(0, 5)),
             "total_s": float(rng.integers(0, 5))} for _ in range(12)]
    assert pareto_flags(rows) == ref_sweep.pareto_flags(rows)
    assert any(pareto_flags(rows))


def test_pareto_flags():
    rows = [
        {"energy_pj": 1.0, "avg_latency": 5.0, "total_s": 1.0},  # front
        {"energy_pj": 2.0, "avg_latency": 1.0, "total_s": 2.0},  # front
        {"energy_pj": 2.0, "avg_latency": 5.0, "total_s": 1.5},  # dominated
    ]
    assert pareto_flags(rows) == [True, True, False]


# ------------------------------------------------------------ sharing keys
KEY_CASES = [
    dict(),
    dict(seed=3, partition_impl="vec", mapper="sa_jax"),
    dict(method="spinemap", partition_impl="vec", seed=2),
    dict(method="sco", seed=5, objective="volume"),
    dict(knobs={"_KERNEL_MAX_N": 7}, partition_kwargs={"plateau_rounds": 0}),
    dict(objective="volume", cast="unicast", mesh_w=8, mesh_h=8),
]


@pytest.mark.parametrize("kw", KEY_CASES)
def test_sharing_keys_match_reference(ref_profile, kw):
    hyper = ref_profile.graph.hyper
    got = ToolchainConfig(device="cpu", **kw).resolve(hyper)
    want = RefConfig(**kw).resolve(hyper)
    assert got.partition_key() == want.partition_key()
    assert got.traffic_key() == want.traffic_key()


def test_sharing_keys_ignore_mapping_and_device():
    a = ToolchainConfig(seed=1, mapper="sa", device="cpu").resolve()
    b = ToolchainConfig(seed=1, mapper="sa_jax", mesh_w=5,
                        noc_kwargs={"stepper": "jax"}).resolve()
    assert a.partition_key() == b.partition_key()
    assert a.traffic_key() == b.traffic_key()
    assert a.partition_key() != ToolchainConfig(seed=2).resolve().partition_key()
    # sco draws no randomness: its key is seed-free
    assert (ToolchainConfig(method="sco", seed=1).resolve().partition_key()
            == ToolchainConfig(method="sco", seed=9).resolve().partition_key())
    assert (ToolchainConfig(objective="volume").resolve().traffic_key()
            != ToolchainConfig(objective="volume", cast="unicast")
            .resolve().traffic_key())


# ------------------------------------------------- batched population SA
def _traffics():
    """tests/test_sweep.py's bucket: k in {12, 14} on 16 cores."""
    rng = np.random.default_rng(1)
    traffics = [rng.integers(0, 50, (k, k)).astype(np.float64)
                for k in (12, 14)]
    return traffics, [int(t.sum()) for t in traffics]


@pytest.mark.parametrize("seeds", [[5, 9], [9, 5], [3, 3]])
def test_sa_search_jax_batch_matches_single(seeds):
    traffics, tls = _traffics()
    kw = dict(iters=1000, chains=4, device="cpu")
    singles = [md.sa_search_jax(t, 16, 4, tl, seed=s, **kw)
               for t, tl, s in zip(traffics, tls, seeds)]
    batch = md.sa_search_jax_batch(traffics, 16, 4, tls, seeds, **kw)
    assert len(batch) == 2
    for s, b in zip(singles, batch):
        np.testing.assert_array_equal(s.placement, b.placement)
        assert s.avg_hop == b.avg_hop
        assert s.history == b.history
        assert s.evaluations == b.evaluations == 4000


def test_sa_search_jax_batch_of_three_without_polish():
    traffics, tls = _traffics()
    traffics = traffics + [traffics[0][:10, :10]]
    tls = tls + [int(traffics[2].sum())]
    kw = dict(iters=640, chains=3, polish=False, device="cpu")
    batch = md.sa_search_jax_batch(traffics, 16, 4, tls, [1, 2, 3], **kw)
    for i, (t, tl) in enumerate(zip(traffics, tls)):
        single = md.sa_search_jax(t, 16, 4, tl, seed=i + 1, **kw)
        np.testing.assert_array_equal(single.placement, batch[i].placement)
        assert single.avg_hop == batch[i].avg_hop
        assert len(set(batch[i].placement.tolist())) == t.shape[0]


def test_sa_search_jax_batch_edge_cases():
    traffics, tls = _traffics()
    assert md.sa_search_jax_batch([], 16, 4, [], [], device="cpu") == []
    with pytest.raises(ValueError, match="must align"):
        md.sa_search_jax_batch(traffics, 16, 4, tls[:1], [0, 1], device="cpu")


# ------------------------------------------------------------------ sweep
@pytest.fixture(scope="module")
def host_grid():
    return config_grid(mesh=[(4, 4)], seed=[0, 1], mapper="sa",
                       objective=["cut", "volume"],
                       mapper_kwargs=[dict(FAST)], device="cpu")


@pytest.fixture(scope="module")
def small_grid(host_grid):
    return host_grid + config_grid(
        mesh=[(4, 4)], seed=[0, 1], mapper="sa_jax",
        mapper_kwargs=[{"iters": 800, "chains": 4}], stepper=["jax"],
        device="cpu")


@pytest.fixture(scope="module")
def swept(profile, small_grid):
    return run_sweep(profile, small_grid)


def test_host_mapper_rows_match_reference(ref_profile, profile, host_grid):
    got = run_sweep(profile, host_grid)
    want = ref_sweep.run_sweep(ref_profile, ref_sweep.config_grid(
        mesh=[(4, 4)], seed=[0, 1], mapper="sa", objective=["cut", "volume"],
        mapper_kwargs=[dict(FAST)]))
    assert len(got.rows) == len(want.rows) == 4
    for a, b in zip(got.rows, want.rows):
        assert _stats(a) == _stats(b)
        assert set(a) == set(b)


def test_baseline_rows_match_reference(ref_profile, profile):
    axes = dict(method=["spinemap", "sco"], mesh=[(5, 5)],
                mapper_kwargs=[{"iters": 40}])
    got = run_sweep(profile, config_grid(device="cpu", **axes))
    want = ref_sweep.run_sweep(ref_profile, ref_sweep.config_grid(**axes))
    for a, b in zip(got.rows, want.rows):
        assert _stats(a) == _stats(b)


def test_sweep_rows_match_sequential_bitwise(profile, small_grid, swept):
    assert len(swept.rows) == len(swept.results) == len(small_grid)
    for cfg, row, res in zip(small_grid, swept.rows, swept.results):
        single = run_toolchain(profile, config=cfg)
        for k, v in single.summary().items():
            if k not in DROP:
                assert row[k] == v, (k, cfg.mapper, cfg.seed, cfg.objective)
        np.testing.assert_array_equal(res.mapping.placement,
                                      single.mapping.placement)


def test_sweep_sa_jax_rows_are_the_batched_search(profile, small_grid, swept):
    """The sa_jax rows came from one bucket, and their placements are the
    single searches' on each row's traffic."""
    from repro_torch.core.pipeline import build_traffic

    for cfg, res in zip(small_grid, swept.results):
        if cfg.mapper != "sa_jax":
            continue
        c = cfg.resolve(profile.graph.hyper)
        traffic = build_traffic(profile, res.partition, c)
        single = md.sa_search_jax(traffic, 16, 4, int(traffic.sum()),
                                  seed=phase_seeds(cfg.seed)[1], iters=800,
                                  chains=4, device="cpu")
        np.testing.assert_array_equal(res.mapping.placement, single.placement)
    jax_rows = [r for r in swept.rows if r["mapper"] == "sa_jax"]
    assert len({r["mapping_s"] for r in jax_rows}) == 1  # amortized bucket


def test_sweep_unbatched_equals_batched(profile, small_grid, swept):
    plain = run_sweep(profile, small_grid, batch_device=False)
    for a, b in zip(plain.rows, swept.rows):
        assert _stats(a) == _stats(b)


def test_sweep_deterministic(profile, small_grid, swept):
    again = run_sweep(profile, small_grid)
    for a, b in zip(again.rows, swept.rows):
        assert _stats(a) == _stats(b)


def test_sweep_pareto_and_dedup(profile, small_grid, swept):
    msgs = []
    res = run_sweep(profile, small_grid, progress=msgs.append)
    shared = {c.resolve(profile.graph.hyper).partition_key()
              for c in small_grid}
    assert len(shared) == 4 < len(small_grid)
    assert msgs[0] == f"{profile.name}: 4 partition runs for 6 configs"
    assert any("sa_jax bucket of 2 configs" in m for m in msgs)
    front = res.front()
    assert 1 <= len(front) <= len(res.rows)
    assert all(r["pareto"] for r in front)
    assert res.front("no such workload") == []


def test_sweep_writes_csv(swept, tmp_path):
    path = tmp_path / "rows.csv"
    swept.write_csv(path)
    lines = path.read_text().splitlines()
    assert len(lines) == len(swept.rows) + 1
    assert lines[0].split(",")[:2] == ["method", "snn"]
    assert isinstance(swept, SweepResult) and swept.seconds > 0


def test_sweep_refuses_tree_on_sa_jax(profile):
    grid = config_grid(mapper="sa_jax", objective="volume",
                       place_objective="tree", mesh=[(4, 4)],
                       mapper_kwargs=[{"iters": 64, "chains": 2}], device="cpu")
    with pytest.raises(ValueError, match="tree objective"):
        run_sweep(profile, grid)


def test_sweep_on_two_workloads(profile):
    other = dataclasses.replace(profile, name="smooth_320_copy")
    grid = config_grid(mesh=[(4, 4)], seed=0, mapper="sa",
                       mapper_kwargs=[dict(FAST)], device="cpu")
    res = run_sweep([profile, other], grid)
    assert [r["snn"] for r in res.rows] == [profile.name, "smooth_320_copy"]
    assert _stats(res.rows[0]) | {"snn": ""} == _stats(res.rows[1]) | {"snn": ""}
