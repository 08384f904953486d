"""Hand-written CUDA kernels for the toolchain's device hot spots.

Each subpackage mirrors the reference's layout:

  ``kernel.py`` — binds and launches the CUDA kernel from ``csrc/`` (built
                  by ``nvcc`` at first use, see ``_build``) and counts its
                  launches in a plain integer ``launches``;
  ``ref.py``    — the plain PyTorch version of the same function;
  ``ops.py``    — the public wrapper: a CPU tensor goes to the plain
                  version, a CUDA tensor to the kernel.  There is no
                  fallback from the kernel to the plain version.

  lif_step   — LIF membrane update + spike detect (profiling loop).
  gain_eval  — cut-mode partition degree rows (vec refiner).
  swap_delta — all-pairs SA swap deltas (batched mapper's device scorer).
  link_load  — per-window XY link loads (NoC replay contention screen).
"""
