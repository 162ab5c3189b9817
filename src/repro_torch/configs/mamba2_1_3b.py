"""mamba2-1.3b — [ssm] 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]

vocab 50280 is padded to 50304 (multiple of 128) for clean TP sharding; the
padding ids are masked out of the loss (see DESIGN.md).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    attention="none",
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,         # d_inner=4096 -> 64 heads
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
    norm="rmsnorm",
    source="arXiv:2405.21060; unverified",
)
