"""Hand-written CUDA kernels for the toolchain's device hot spots.

Each subpackage mirrors the reference's layout:

  ``kernel.py`` — binds and launches the CUDA kernel from ``csrc/`` (built
                  by ``nvcc`` at first use, see ``_build``) and counts its
                  launches in a plain integer per kernel (``launches``;
                  gain_eval's second kernel has ``connectivity_launches``);
  ``ref.py``    — the plain PyTorch version of the same function;
  ``ops.py``    — the public wrapper: a CPU tensor goes to the plain
                  version, a CUDA tensor to the kernel.  There is no
                  fallback from the kernel to the plain version.

  lif_step   — LIF step with the synaptic product fused in (profiling
               loop), and the membrane update alone.
  gain_eval  — cut-mode partition degree rows and volume-mode
               connectivity degree rows (vec refiner).
  swap_delta — all-pairs SA swap deltas (batched mapper's device scorer).
  link_load  — per-window XY link loads of packet records (NoC replay
               contention screen), and the unicast replay's two tier-1
               screens in one pass a window (``replay_screen``).
  hop_eval   — total hop cost of a placement (Algorithm 1).
"""
