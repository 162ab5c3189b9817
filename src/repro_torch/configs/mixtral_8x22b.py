"""mixtral-8x22b — [moe] 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,                  # every FFN is MoE
    moe_d_ff=16384,
    num_experts=8,
    num_experts_per_tok=2,
    vocab_size=32768,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    opt_dtype="bfloat16",    # 141B params: bf16 moments to fit one pod
    source="arXiv:2401.04088; hf",
)
