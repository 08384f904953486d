"""llama-3.2-vision-11b [vlm]: 8B text backbone + 8 gated cross-attn layers.

40L total = 32 self-attention + 8 cross-attention (one after every 4 self
layers), d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=128256.  The
vision tower is a STUB: input_specs() supplies precomputed patch
embeddings (B, 1601, 4096) that the cross layers attend to.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    cross_attn_every=4,
    frontend_seq=1601,
    frontend_dim=4096,
    notes="vision frontend stubbed as precomputed patch embeddings",
)
