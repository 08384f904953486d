"""qwen3-moe-30b-a3b [moe]: 128 experts top-8, qk-norm.

48L, d_model=2048, 32H (GQA kv=4, head_dim 128), moe_d_ff=768,
vocab=151936, no shared experts.  [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    num_experts=128,
    top_k=8,
    moe_d_ff=768,
    notes="128 routed experts, top-8, qk-norm",
)
