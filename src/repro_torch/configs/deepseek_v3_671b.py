"""deepseek-v3-671b — [moe] 61L d_model=7168 128H (GQA kv=128) d_ff=2048
vocab=129280, MoE 256 experts top-8 — MLA, 1 shared + 256 routed, MTP.
[arXiv:2412.19437; hf]

Notes: d_ff=2048 is the per-expert (routed) FFN width; the first 3 layers
are dense with the published 18432 width.  Attention is MLA with the
published low-rank dims; MTP implemented as a depth-1 extra prediction head.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,        # MLA: kv heads == q heads post-expansion
    d_ff=18432,              # first_k_dense layers
    moe_d_ff=2048,
    num_experts=256,
    num_experts_per_tok=8,
    num_shared_experts=1,
    first_k_dense=3,
    vocab_size=129280,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    mtp_depth=1,
    rope_theta=10000.0,
    opt_dtype="bfloat16",    # 671B: bf16 moments (DeepSeek-V3 trains low-prec)
    source="arXiv:2412.19437; hf",
)
