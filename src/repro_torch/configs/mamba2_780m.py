"""mamba2-780m [ssm]: attention-free SSD.  48L, d_model=1536, d_inner=3072
(expand 2, 48 heads of 64), ssm_state=128, vocab=50280.  O(1)-state decode
=> runs long_500k.  [arXiv:2405.21060; unverified]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    long_context_ok=True,
    notes="attention-free; head sharding -> SSD heads (DESIGN.md)",
)
