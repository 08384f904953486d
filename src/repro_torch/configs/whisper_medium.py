"""whisper-medium [audio]: enc-dec, conv frontend stubbed.

24 encoder + 24 decoder layers, d_model=1024, 16H, d_ff=4096, vocab=51865.
input_specs() supplies precomputed post-conv frame embeddings (B, 1500,
1024); rope replaces whisper's absolute embeddings (structural equivalence,
see DESIGN.md).  [arXiv:2212.04356; unverified]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    encoder_layers=24,
    frontend_seq=1500,
    frontend_dim=1024,
    notes="conv frontend stubbed; enc-dec",
)
