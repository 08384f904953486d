"""The port's device stepper (``stepper="jax"``, `nocsim.replay_device`)
against the reference on the CPU: every NoCStats field equal to the
reference's scalar engine (``engine="ref"``) and to its own JAX stepper,
and latencies equal to the numpy joint stepper's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import random_spike_trace  # noqa: E402
from repro.nocsim import simulate_noc as ref_simulate_noc  # noqa: E402
from repro.snn import make_snn, profile_snn  # noqa: E402

from repro_torch.nocsim import replay, replay_device, simulate_noc  # noqa: E402
from repro_torch.nocsim.xy import link_count, link_ids_for_routes  # noqa: E402


def assert_stats_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.fixture
def stepped(monkeypatch):
    """Counts the device stepper's calls and the packets it stepped."""
    seen = {"calls": 0, "packets": 0}
    inner = replay.joint_stepper_device

    def spy(src, *args, **kwargs):
        seen["calls"] += 1
        seen["packets"] += int(src.shape[0])
        return inner(src, *args, **kwargs)

    monkeypatch.setattr(replay, "joint_stepper_device", spy)
    return seen


@pytest.fixture(scope="module")
def smooth_320():
    return profile_snn(make_snn("smooth_320"), num_steps=300, seed=0)


@pytest.mark.parametrize("link_capacity", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_stepper_matches_reference_engines(stepped, link_capacity, seed):
    t, src, dst, part, placement = random_spike_trace(
        seed=seed, n_spikes=1500, timesteps=8)
    args = (t, src, dst, part, placement, 3, 3)
    ref = ref_simulate_noc(*args, link_capacity=link_capacity, engine="ref")
    ref_jax = ref_simulate_noc(*args, link_capacity=link_capacity,
                               engine="batched", stepper="jax")
    got = simulate_noc(*args, link_capacity=link_capacity, stepper="jax",
                       device="cpu")
    assert ref.congestion_count > 0
    assert stepped["calls"] == 1 and stepped["packets"] > 0
    assert_stats_equal(got, ref)
    assert_stats_equal(got, ref_jax)


@pytest.mark.parametrize("link_capacity", [1, 2])
def test_device_stepper_matches_reference_on_smooth_320(stepped, smooth_320,
                                                        link_capacity):
    prof = smooth_320
    part = np.arange(prof.num_neurons) % 22
    placement = np.random.default_rng(4).permutation(25)[:22]
    args = (prof.trace_t, prof.trace_src, prof.trace_dst, part, placement, 5, 5)
    ref = ref_simulate_noc(*args, link_capacity=link_capacity)
    ref_jax = ref_simulate_noc(*args, link_capacity=link_capacity, stepper="jax")
    got = simulate_noc(*args, link_capacity=link_capacity, stepper="jax",
                       screen="linkload", device="cpu")
    assert ref.congestion_count > 0 and stepped["packets"] > 0
    assert_stats_equal(got, ref)
    assert_stats_equal(got, ref_jax)


def test_undrainable_window_raises():
    t, src, dst, part, placement = random_spike_trace(seed=0, n_spikes=200)
    with pytest.raises(RuntimeError, match="drain"):
        simulate_noc(t, src, dst, part, placement, 3, 3, link_capacity=0,
                     stepper="jax", max_cycles_per_window=50, device="cpu")


def test_multicast_accepts_the_knob_without_effect():
    t, src, dst, part, placement = random_spike_trace(seed=2, n_spikes=800,
                                                      timesteps=6)
    args = (t, src, dst, part, placement, 3, 3)
    kw = dict(cast="multicast", link_capacity=2, device="cpu")
    assert_stats_equal(simulate_noc(*args, stepper="jax", **kw),
                       simulate_noc(*args, **kw))


def _numpy_stepper(src, dst, inject, win, w, h, link_capacity, max_cycles):
    """The port's numpy joint stepper on the same packets."""
    nl = link_count(w, h)
    ids, pkt, step = link_ids_for_routes(src, dst, w, h, with_steps=True)
    hops = np.bincount(pkt, minlength=src.shape[0])
    return replay._joint_stepper(ids, pkt, step, hops, inject, win, nl,
                                 link_capacity, max_cycles)


@pytest.mark.parametrize("check_every", [1, 5, 32])
@pytest.mark.parametrize("link_capacity", [1, 3])
def test_joint_stepper_device_equals_numpy_stepper(monkeypatch, check_every,
                                                   link_capacity):
    """Random packets over several windows of a 5 x 4 mesh, with the host
    reading (and compacting) the state every 1, 5 or 32 cycles."""
    monkeypatch.setattr(replay_device, "CHECK_EVERY", check_every)
    rng = np.random.default_rng(check_every * 10 + link_capacity)
    w, h, n = 5, 4, 3000
    src = rng.integers(0, w * h, n)
    dst = (src + rng.integers(1, w * h, n)) % (w * h)  # remote packets only
    win = np.sort(rng.integers(0, 7, n))
    win = np.unique(win, return_inverse=True)[1]
    inject = rng.integers(0, 12, n)
    want = _numpy_stepper(src, dst, inject, win, w, h, link_capacity, 100_000)
    got = replay_device.joint_stepper_device(
        src, dst, inject, win, w, h, link_count(w, h), link_capacity, 100_000,
        device="cpu")
    assert want[1] > 0
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("w,h", [(5, 4), (1, 6), (7, 1), (16, 16)])
def test_route_tags_walk_the_xy_route(w, h):
    """The affine per-leg link ids of `_routes` give each packet's XY route
    link by link, offset by its window, with int32 and int64 tags."""
    rng = np.random.default_rng(w * h)
    n = 200
    src = rng.integers(0, w * h, n)
    dst = rng.integers(0, w * h, n)
    win = rng.integers(0, 5, n)
    nl = link_count(w, h)
    ids, pkt, step = link_ids_for_routes(src, dst, w, h, with_steps=True)
    for dtype in (torch.int32, torch.int64):
        ta, hs, nh, tb, vs, hops = replay_device._routes(
            torch.tensor(src), torch.tensor(dst), torch.tensor(win), w, h, nl,
            dtype)
        assert ta.dtype == tb.dtype == dtype
        np.testing.assert_array_equal(hops.numpy(),
                                      np.bincount(pkt, minlength=n))
        k = torch.tensor(step)
        p = torch.tensor(pkt)
        tag = torch.where(k < nh[p], ta[p] + hs[p] * k, tb[p] + vs[p] * k)
        np.testing.assert_array_equal(tag.numpy(), win[pkt] * nl + ids)
