"""jamba-1.5-large-398b — [hybrid] 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16 experts top-2 — Mamba+attention 1:7
interleave, MoE every other layer.  [arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    moe_d_ff=24576,
    num_experts=16,
    num_experts_per_tok=2,
    vocab_size=65536,
    attn_period=8,           # 1 attention layer per 8 (rest Mamba)
    moe_period=2,            # MoE FFN every 2nd layer
    ssm_state=128,
    ssm_head_dim=128,        # d_inner=16384 -> 128 mamba heads
    ssm_expand=2,
    rope_theta=0.0,          # Jamba uses no positional encoding
    norm="rmsnorm",
    opt_dtype="bfloat16",    # 398B: bf16 moments
    source="arXiv:2403.19887; hf",
)
