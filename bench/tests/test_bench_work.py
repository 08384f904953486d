"""The per-layer metrics' work counts against hand counts at tiny sizes."""
from __future__ import annotations

import numpy as np

import harness


def test_lif_step_bytes_by_hand():
    lif = harness.load_reader("lif_roofline")
    # 3 neurons, 2 synapses: 2 x (4 B source + 4 B weight) + 3 x (4 B count
    # + 1 B previous raster + 4 B drive + 2 x 4 B v + 2 x 4 B refr + 1 B
    # raster out) = 16 + 78.
    assert lif.step_bytes(3, 2) == 16 + 78


def test_sa_work_by_hand():
    sa = harness.load_reader("sa_roofline")
    call = {"traffics": [np.zeros((3, 3))], "iters": 130,
            "sweeps_per_temp": 64, "chains": 2}
    nbytes, f64, tf32 = sa.job_work(call, polish_steps=5)
    proposals = 2 * 64 * 2  # 130 // 64 = 2 epochs of 64 steps, 2 chains
    assert nbytes == proposals * 4 * 3 * 8 + 5 * 2 * 9 * 4
    assert f64 == proposals * 4 * 3
    assert tf32 == 5 * 2 * 27
    # Fewer iterations than one epoch still run one epoch.
    assert sa.job_work({**call, "iters": 10}, 0)[1] == 64 * 2 * 4 * 3
