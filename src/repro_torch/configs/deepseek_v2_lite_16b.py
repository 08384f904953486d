"""deepseek-v2-lite-16b [moe]: MLA attention + fine-grained MoE.

27L, d_model=2048, 16H, MLA (kv_lora_rank=512, rope_head=64, qk/v head
128), vocab=102400. MoE: 64 routed experts top-6 + 2 shared, moe_d_ff=1408,
first layer dense (d_ff=10944).  NOTE: the assignment line lists both
"64e" and "160 routed"; the official DSv2-Lite config is 64 routed + 2
shared, which we follow (see DESIGN.md §Arch-applicability).
[arXiv:2405.04434; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,  # the single leading dense layer
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    rope_head_dim=64,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    notes="MLA latent cache; 64 routed + 2 shared experts",
)
