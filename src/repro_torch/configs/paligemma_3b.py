"""paligemma-3b — [vlm] 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216 — SigLIP frontend (STUB) + gemma decoder.
[arXiv:2407.07726; hf]

Per the brief, the vision frontend is a stub: ``input_specs()`` supplies 256
precomputed patch embeddings which are prepended to the token sequence with
PaliGemma's prefix-LM attention mask (full attention over the prefix).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    num_prefix_tokens=256,
    prefix_lm=True,
    frontend="vision_stub",
    act="gelu",
    tie_embeddings=True,
    rope_theta=10000.0,
    source="arXiv:2407.07726; hf",
)
