"""The reading of a profiler trace, on a hand-made one."""
from __future__ import annotations

import tracing


def _ev(cat, name, ts, dur):
    kind = "span" if cat == "user_annotation" else "device"
    return (kind, name, ts * 1e-6, (ts + dur) * 1e-6)


def test_parse_busy_spans_and_gaps():
    events = [
        _ev("user_annotation", "bench.job", 0, 1000),
        _ev("user_annotation", "bench.partition_phase", 0, 400),
        _ev("user_annotation", "bench.mapping_phase", 400, 600),
        _ev("kernel", "part_degrees_kernel", 100, 100),
        _ev("kernel", "sa_step", 500, 100),
        _ev("gpu_memcpy", "Memcpy HtoD", 550, 100),  # overlaps the kernel
        _ev("kernel", "spin_kernel", 1100, 10),
        _ev("user_annotation", "aten-free host span", 0, 5),
    ]
    tr, marker = tracing._parse(events)
    assert marker
    assert abs(tr.busy_s - 250e-6) < 1e-12
    assert abs(tr.device_s("bench.mapping_phase") - 150e-6) < 1e-12
    assert tr.device_s("bench.evaluate_phase") is None
    gaps = dict()
    for name, s in tr.gaps():
        gaps[name] = gaps.get(name, 0.0) + s
    # A gap goes to the innermost span around its middle: 0-100 and
    # 200-500 to the partition, 650-1000 to the mapping.
    assert abs(gaps["bench.partition_phase"] - 400e-6) < 1e-12
    assert abs(gaps["bench.mapping_phase"] - 350e-6) < 1e-12
    assert abs(sum(gaps.values()) + tr.busy_s - 1000e-6) < 1e-12
    assert "spin_kernel" not in tr.ops


def test_hooks_wrap_and_restore():
    import repro_torch.core.pipeline as pipeline

    inner = pipeline.partition_phase
    hooks = tracing.Hooks([("repro_torch.core.pipeline", "partition_phase")],
                          [("repro_torch.kernels.swap_delta.kernel", "launches")])
    assert pipeline.partition_phase is not inner
    hooks.close()
    assert pipeline.partition_phase is inner


def test_hooks_refuse_a_missing_entry():
    import pytest

    with pytest.raises(RuntimeError):
        tracing.Hooks([("repro_torch.core.pipeline", "no_such_phase")], [])
