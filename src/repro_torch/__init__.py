"""SNEAP toolchain on PyTorch and CUDA: the port of ``repro``.

Profile an SNN with LIF dynamics (`snn.profile_snn`), partition it with
the multilevel engines (`core.sneap_partition`), place the partitions on
the NoC mesh (`core.mapping.sa_search`) and replay the spike trace through
the queued NoC simulator (`nocsim.simulate_noc`); `core.run_toolchain`
drives all of it.  Entry points run on the card (``device="cuda"``) unless
the caller asks for the CPU, and the device hot spots go through the
hand-written kernels of `repro_torch.kernels`.

The package imports torch and numpy only, never jax and nothing of
``repro``; `interop` turns the reference's artifacts, given as plain
numpy fields, into this package's dataclasses.
"""
