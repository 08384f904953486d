"""Parameter initialization: the reference's tree, shapes, dtypes and rules,
drawn from a ``torch.Generator``.

Every weight matrix is a standard normal truncated to ±3 times
fan_in**-0.5 (drawn in f32, cast to its dtype); norms and ``d_skip`` are
ones, ``dt_bias`` and the cross-attention gates zeros, ``a_log`` is
log(linspace(1, 16, H)).  A rank's model (one holding blocks of its
leaves, ``Model.blocks``) draws each such leaf whole and keeps its block,
so its weights are the unsharded model's blocks bit for bit.
Fan-ins follow `init_params` of the reference, on the whole leaf:
the leading dim, except the attention output projections (H * hd), the
token embedding (D) and the routed experts (the dim after E).  jax's
random stream cannot be reproduced; `repro_torch.interop.model_params_from`
carries the reference's weights over where a test needs them.
"""
from __future__ import annotations

import torch
from torch import nn

from .blocks import MoE
from .layers import init_dense

__all__ = ["init_params"]

_ONES = {"attn_norm", "mlp_norm", "attn_out_norm", "ssm_out_norm", "self_norm",
         "cross_norm", "pre_norm", "final_norm", "enc_norm", "q_norm", "k_norm",
         "norm", "d_skip"}
_ZEROS = {"dt_bias", "gate_attn", "gate_mlp"}


def _fan_in(owner: nn.Module, leaf: str, shape) -> int:
    if leaf in ("wo", "w_o"):
        return shape[0] * shape[1]
    if leaf == "embed" or (isinstance(owner, MoE) and leaf != "router"):
        return shape[1]
    return shape[0]


def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``model`` in place, in ``named_parameters``
    order, from ``generator`` (on the parameters' device); a parameter
    named in ``model.blocks`` (name -> (whole shape, block)) is that block
    of the whole leaf's draw."""
    blocks = getattr(model, "blocks", {})
    with torch.no_grad():
        for prefix, owner in model.named_modules():
            for leaf, param in owner.named_parameters(recurse=False):
                whole, block = blocks.get(f"{prefix}.{leaf}" if prefix else leaf,
                                          (tuple(param.shape), None))
                if leaf in _ONES:
                    param.fill_(1.0)
                elif leaf in _ZEROS:
                    param.zero_()
                elif leaf == "a_log":
                    h = param.shape[0]
                    param.copy_(torch.log(torch.linspace(1.0, 16.0, h)))
                else:
                    init_dense(param, generator,
                               fan_in=_fan_in(owner, leaf, whole), whole=whole,
                               block=block)
    return model
