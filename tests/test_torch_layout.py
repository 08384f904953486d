"""The port's SNEAP device-layout search against the reference on the CPU.

The four cases of tests/test_layout.py run through the port, with the
reference's ``order``, ``base`` and ``optimized`` as the oracle, bitwise:
the search is host numpy in both packages (the port's scalar ``sa_search``
is the reference's chain)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sharding.layout import logical_traffic_matrix as ref_traffic  # noqa: E402
from repro.sharding.layout import sneap_device_layout as ref_layout  # noqa: E402

from repro_torch.sharding import logical_traffic_matrix, sneap_device_layout  # noqa: E402


def _layout(*args, **kwargs):
    """The port's and the reference's layouts of the same call, which
    must agree bitwise."""
    got = sneap_device_layout(*args, device="cpu", **kwargs)
    want = ref_layout(*args, **kwargs)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype
    assert got[1:] == want[1:]
    return got


@pytest.mark.parametrize("patterns", [None, {"model": "alltoall"},
                                      {"data": "alltoall", "model": "alltoall"}])
def test_logical_traffic_matches_reference(patterns):
    args = ({"data": 4, "model": 6}, {"data": 3.0, "model": 10.0, "pod": 7.0},
            patterns)
    got = logical_traffic_matrix(*args)
    np.testing.assert_array_equal(got, ref_traffic(*args))


def test_logical_traffic_ring_edges():
    t = logical_traffic_matrix({"data": 4, "model": 4},
                               {"data": 1.0, "model": 10.0})
    # model-axis ring neighbors exchange the model volume symmetrically
    assert t[0, 1] == 10.0 and t[1, 0] == 10.0
    assert t[0, 4] == 1.0  # data neighbor
    assert t.sum() > 0 and np.allclose(t, t.T)


def test_layout_never_regresses_identity():
    order, base, optimized = _layout(
        {"data": 8, "model": 8}, {"data": 1e6, "model": 64e6},
        phys_w=8, iters=8_000, seed=0)
    assert sorted(order.tolist()) == list(range(64))
    assert optimized <= base + 1e-9


def test_layout_respects_dead_chips():
    order, base, optimized = _layout(
        {"data": 6, "model": 10}, {"data": 1e6, "model": 64e6},
        phys_w=8, iters=10_000, seed=0, dead_chips=[5, 22, 40, 41])
    alive = [c for c in range(64) if c not in (5, 22, 40, 41)]
    assert sorted(order.tolist()) == alive
    assert optimized <= base


def test_layout_improves_alltoall_traffic():
    """MoE expert-parallel all-to-all on the model axis: row-major lines
    are suboptimal (compact blocks have lower mean pairwise distance);
    seeded-hot SA must strictly improve."""
    order, base, optimized = _layout(
        {"data": 16, "model": 16}, {"data": 5e8, "model": 5e9},
        phys_w=16, iters=120_000, seed=0, patterns={"model": "alltoall"})
    assert optimized < base * 0.95
    assert sorted(order.tolist()) == list(range(256))


def test_layout_refuses_a_ragged_torus():
    with pytest.raises(ValueError, match="rows of 8"):
        sneap_device_layout({"data": 3, "model": 5}, {"data": 1.0},
                            phys_w=8, device="cpu")


def test_layout_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sneap_device_layout({"data": 4, "model": 4}, {"model": 1.0}, phys_w=4,
                            iters=10)
