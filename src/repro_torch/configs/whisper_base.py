"""whisper-base — [audio] 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865 —
encoder-decoder, conv frontend (STUB).  [arXiv:2212.04356; unverified]

Per the brief, the modality frontend is a stub: ``input_specs()`` supplies
precomputed frame embeddings (batch, 1500, d_model) as the encoder input.
Decoder uses learned absolute positions (approximated here with sinusoidal)
and full self/cross attention.  vocab padded 51865 -> 51968.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,            # decoder layers
    num_encoder_layers=6,
    encoder_seq_len=1500,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    is_encoder_decoder=True,
    frontend="audio_stub",
    norm="layernorm",
    act="gelu",
    rope_theta=0.0,          # no RoPE: sinusoidal absolute positions
    source="arXiv:2212.04356; unverified",
)
