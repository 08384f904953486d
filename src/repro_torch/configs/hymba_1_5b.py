"""hymba-1.5b [hybrid]: parallel attention + Mamba-2 heads per layer.

32L, d_model=1600, 25 heads (GQA kv=5, head_dim 64), d_ff=5504,
vocab=32001, ssm_state=16.  Sliding-window attention everywhere except 3
full-attention layers (first/middle/last, following the Hymba recipe);
sub-quadratic decode => runs long_500k.  [arXiv:2411.13676; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    sliding_window=1024,
    global_attn_layers=(0, 15, 31),
    ssm_state=16,
    ssm_expand=1,
    ssm_head_dim=64,
    ssm_chunk=256,
    parallel_ssm=True,
    long_context_ok=True,
    notes="parallel attn+mamba heads; SWA(1024) + 3 global layers",
)
