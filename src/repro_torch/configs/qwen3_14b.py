"""qwen3-14b [dense]: qk-norm, GQA, head_dim 128.  [hf:Qwen/Qwen3-14B; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
