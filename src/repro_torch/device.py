"""Device selection for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``: the
toolchain runs on the card unless the caller asks for the CPU.  There is
no silent fallback — asking for CUDA where no GPU is visible raises.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The ``torch.device`` a run executes on; raises if CUDA is absent.

    Also turns TF32 off for matrix products and convolutions: the degree
    matrices (`kernels.gain_eval`), link loads (`kernels.link_load`) and
    the LIF synaptic product are f32 sums that must stay exact (integer
    counts below 2**24) or match the reference to the last bit, and TF32's
    10-bit mantissa breaks both.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
