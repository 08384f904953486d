"""Architecture configuration: one frozen dataclass drives every model.

Every assigned architecture is a pure-data `ArchConfig`; the model builder
(`repro_torch.models.model`) interprets it.  Reduced (smoke-test) variants are
produced by `ArchConfig.reduced()` so CPU tests exercise the identical
code path at toy scale.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

__all__ = ["ArchConfig"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention flavor ---
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int | None = None  # SWA width; None = full attention
    global_attn_layers: tuple[int, ...] = ()  # full-attn layers in an SWA stack

    # --- MLA (DeepSeek-V2) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    rope_head_dim: int = 0  # decoupled positional sub-head

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0  # leading layers with a dense MLP instead
    capacity_factor: float = 1.25

    # --- SSM (Mamba-2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 1
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_kernel: int = 4

    # --- hybrid (Hymba): parallel attention + SSM heads per layer ---
    parallel_ssm: bool = False

    # --- encoder-decoder / multimodal ---
    encoder_layers: int = 0  # >0 => enc-dec (whisper)
    cross_attn_every: int = 0  # >0 => a cross-attn layer after every N self layers (vlm)
    frontend_seq: int = 0  # stub frontend output length (audio frames / patches)
    frontend_dim: int = 0  # stub frontend embedding width

    # --- numerics ---
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"

    # --- remat policy (perf knob, see EXPERIMENTS.md §Perf) ---
    # "full":   recompute everything in bwd (baseline, paper-faithful default)
    # "save_collectives": checkpoint the TP-collective outputs (attn/mlp/moe
    #           block outputs) so the backward pass never re-runs all-reduces
    remat_policy: str = "full"

    # --- bookkeeping ---
    long_context_ok: bool = False  # sub-quadratic decode => run long_500k
    notes: str = ""

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    def reduced(self) -> "ArchConfig":
        """Same family/flavor at smoke-test scale (CPU-runnable)."""
        scale = dict(
            num_layers=min(self.num_layers, 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            param_dtype="float32",
            activation_dtype="float32",
        )
        if self.use_mla:
            scale.update(kv_lora_rank=32, rope_head_dim=16)
        if self.is_moe:
            # capacity_factor high enough to be drop-free at toy scale, so
            # consistency tests (full == prefill+decode) hold exactly.
            scale.update(num_experts=min(self.num_experts, 8),
                         top_k=min(self.top_k, 2), moe_d_ff=64,
                         capacity_factor=8.0)
        if self.ssm_state:
            scale.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
        if self.sliding_window:
            scale.update(sliding_window=32)
        if self.global_attn_layers:
            scale.update(global_attn_layers=(0, 2, 3))
        if self.encoder_layers:
            scale.update(encoder_layers=2)
        if self.frontend_seq:
            scale.update(frontend_seq=24, frontend_dim=scale["d_model"])
        if self.cross_attn_every:
            # keep num_layers divisible into (self*per + cross) groups
            scale.update(cross_attn_every=2, num_layers=6)
        return dataclasses.replace(self, name=self.name + "-reduced", **scale)

    def params_billion(self) -> float:
        """Rough parameter count (embedding + blocks), for roofline math."""
        d = self.d_model
        emb = self.vocab_size * d
        if self.use_mla:
            r, rh = self.kv_lora_rank, self.rope_head_dim
            attn = (d * self.num_heads * (self.head_dim + rh)  # q (nope+pe)
                    + d * (r + rh)  # kv down + k_pe
                    + r * self.num_heads * self.head_dim * 2  # k_up, v_up
                    + self.num_heads * self.head_dim * d)  # o
        else:
            attn = d * self.num_heads * self.head_dim + \
                2 * d * self.num_kv_heads * self.head_dim + \
                self.num_heads * self.head_dim * d
        if self.is_moe:
            moe = 3 * d * self.moe_d_ff * self.num_experts + d * self.num_experts
            moe += 3 * d * self.moe_d_ff * self.num_shared_experts
            dense_mlp = 3 * d * self.d_ff * self.first_dense_layers
            mlp_total = moe * (self.num_layers - self.first_dense_layers) + dense_mlp
        else:
            mlp_total = 3 * d * self.d_ff * self.num_layers if self.d_ff else 0
        ssm = 0
        if self.ssm_state:
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            ssm = (d * (2 * di + 2 * ns + nh) + di * d + nh) * self.num_layers
        attn_total = attn * self.num_layers if self.num_heads else 0
        if self.ssm_state and not self.parallel_ssm:
            attn_total = 0
        enc = 0
        if self.is_enc_dec:
            # encoder self-attn + mlp, plus decoder cross-attn
            enc = (attn + 3 * d * self.d_ff) * self.encoder_layers + attn * self.num_layers
        if self.cross_attn_every:
            n_cross = self.num_layers // (self.cross_attn_every)
            enc += (attn + 3 * d * self.d_ff) * n_cross
        total = emb + attn_total + mlp_total + ssm + enc
        return total / 1e9

    def active_params_billion(self) -> float:
        """Active parameters per token (MoE top-k instead of all experts)."""
        if not self.is_moe:
            return self.params_billion()
        d = self.d_model
        full = self.params_billion()
        all_moe = 3 * d * self.moe_d_ff * self.num_experts * \
            (self.num_layers - self.first_dense_layers)
        act_moe = 3 * d * self.moe_d_ff * self.top_k * \
            (self.num_layers - self.first_dense_layers)
        return full - (all_moe - act_moe) / 1e9
