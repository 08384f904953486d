"""The port's CUDA kernels against their plain PyTorch versions on the
card: bitwise for lif_step, exact for part_degrees and link_loads, rtol
1e-4 / atol 1e-2 for swap_deltas.  Every test is marked ``cuda`` and skips
where CUDA is unavailable; this file imports torch and numpy only, so it
runs where the reference's JAX is not installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.gain_eval import kernel as gain_kernel  # noqa: E402
from repro_torch.kernels.gain_eval import part_degrees_ref  # noqa: E402
from repro_torch.kernels.lif_step import kernel as lif_kernel  # noqa: E402
from repro_torch.kernels.lif_step import lif_step_ref  # noqa: E402
from repro_torch.kernels.link_load import kernel as link_kernel  # noqa: E402
from repro_torch.kernels.link_load import link_loads_ref  # noqa: E402
from repro_torch.kernels.swap_delta import kernel as swap_kernel  # noqa: E402
from repro_torch.kernels.swap_delta import swap_deltas_ref  # noqa: E402

RNG = np.random.default_rng(0)
LIF_KW = dict(decay=0.9, threshold=1.0, v_reset=0.0, refractory=2)


@pytest.fixture
def cuda():
    """The card, or a skip where CUDA (and so nvcc's kernels) is absent."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 5120])
def test_lif_step_kernel_matches_plain_bitwise(cuda, n):
    v = torch.tensor(RNG.uniform(-0.5, 1.2, n).astype(np.float32), device=cuda)
    refr = torch.tensor(RNG.integers(0, 3, n).astype(np.int32), device=cuda)
    cur = torch.tensor(RNG.uniform(0, 0.6, n).astype(np.float32), device=cuda)
    got = lif_kernel.lif_step_cuda(v, refr, cur, **LIF_KW)
    want = lif_step_ref(v, refr, cur, **LIF_KW)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(7, 3), (513, 130), (3072, 141)])
def test_part_degrees_kernel_matches_plain_exactly(cuda, n, k):
    a = RNG.integers(0, 40, (n, n)).astype(np.float32) * (RNG.random((n, n)) < 0.05)
    a = a + a.T
    adj = torch.tensor(a, device=cuda)
    part = torch.tensor(RNG.integers(0, k, n).astype(np.int32), device=cuda)
    rows = torch.tensor(RNG.permutation(n)[: n // 2 + 1], device=cuda)
    assert torch.equal(gain_kernel.part_degrees_cuda(adj, part, k, rows),
                       part_degrees_ref(adj, part, k, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 100, 256, 300])
def test_swap_deltas_kernel_matches_plain(cuda, k):
    c = RNG.integers(0, 100, (k, k)).astype(np.float32)
    sym = torch.tensor(c + c.T, device=cuda)
    x = torch.tensor(RNG.integers(0, 16, k).astype(np.float32), device=cuda)
    y = torch.tensor(RNG.integers(0, 16, k).astype(np.float32), device=cuda)
    got = swap_kernel.swap_deltas_cuda(sym, x, y)
    torch.testing.assert_close(got, swap_deltas_ref(sym, x, y), rtol=1e-4, atol=1e-2)
    assert float(torch.diagonal(got).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,w,h", [(1, 5, 5), (3, 8, 4), (256, 16, 16)])
def test_link_loads_kernel_matches_plain_exactly(cuda, b, w, h):
    k = w * h
    counts = RNG.integers(0, 5, (b, k, k)) * (RNG.random((b, k, k)) < 0.1)
    counts = torch.tensor(counts.astype(np.int32), device=cuda)
    cores = torch.arange(k, dtype=torch.int32, device=cuda)
    x, y = cores % w, cores // w
    assert torch.equal(link_kernel.link_loads_cuda(counts, x, y, w, h),
                       link_loads_ref(counts, x, y, w, h))
