"""Architecture configuration schema (a copy of ``repro.configs.base``).

Every architecture is expressed as an ``ArchConfig``.  The model stack in
``repro_torch.models`` is driven entirely by this dataclass — there is no
per-arch model code, only per-arch configs (plus family-level layer code).
Plain data, kept field for field equal to the reference's so that the
analytic parameter counts and smoke reductions agree.

Shapes (the per-arch input-shape set) are global:
    train_4k      seq_len=4096    global_batch=256   (train_step)
    prefill_32k   seq_len=32768   global_batch=32    (prefill_step)
    decode_32k    seq_len=32768   global_batch=128   (serve_step, 1 new token)
    long_500k     seq_len=524288  global_batch=1     (serve_step, 1 new token)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

VOCAB_PAD_MULTIPLE = 128  # vocab padded so TP over 16-way model axis divides


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                   # 0 for attention-free layers
    num_kv_heads: int
    d_ff: int                        # dense FFN width (0 if every layer is MoE/SSM)
    vocab_size: int

    head_dim: int = 0                # 0 -> d_model // num_heads
    # --- attention flavour ---
    attention: str = "gqa"           # gqa | mla | none
    sliding_window: int = 0          # 0 = full attention
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    prefix_lm: bool = False          # PaliGemma-style full attention on prefix
    # --- MLA (DeepSeek) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert FFN width
    first_k_dense: int = 0           # leading dense layers (DeepSeek-V3 uses 3)
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_period: int = 0             # hybrid: 1 attention layer every `period`
                                     # layers (rest SSM); 0 = not hybrid
    moe_period: int = 0              # hybrid: MoE FFN every `period` layers
    # --- encoder/decoder & multimodal ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500      # whisper-base: 30 s of audio frames
    num_prefix_tokens: int = 0       # VLM: # of precomputed patch embeddings
    frontend: str = "none"           # none | audio_stub | vision_stub
    # --- extra heads ---
    mtp_depth: int = 0               # DeepSeek-V3 multi-token prediction depth
    # --- numerics / training ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5
    act: str = "silu"                # silu (SwiGLU) | gelu (plain MLP)
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    opt_dtype: str = "float32"       # bf16 moments for the 398B/671B MoEs
    remat: str = "full"              # none | full | dots  (activation ckpt)
    # provenance
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads == 0:
            return 0
        return self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        m = VOCAB_PAD_MULTIPLE
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_hybrid(self) -> bool:
        return self.attn_period > 0

    @property
    def is_ssm(self) -> bool:
        return self.family == "ssm"

    @property
    def uses_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if a 500k-token decode is feasible (bounded per-token state)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Params active per token (MoE: shared + top-k experts only)."""
        return _param_count(self, active_only=True)

    # ------------------------------------------------------------------
    def smoke(self) -> "ArchConfig":
        """A reduced same-family config for CPU smoke tests."""
        changes = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2 if self.attn_period == 0 else 2 * self.attn_period),
            d_model=128,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=32 if self.num_heads else 0,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            remat="none",
        )
        if self.uses_moe:
            changes.update(num_experts=4, num_experts_per_tok=min(2, self.num_experts_per_tok),
                           moe_d_ff=128, first_k_dense=min(self.first_k_dense, 1),
                           num_shared_experts=min(self.num_shared_experts, 1))
        if self.attention == "mla":
            changes.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                           qk_rope_head_dim=16, v_head_dim=32)
        if self.ssm_state:
            changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
        if self.is_encoder_decoder:
            changes.update(num_encoder_layers=2, encoder_seq_len=64)
        if self.num_prefix_tokens:
            changes.update(num_prefix_tokens=16)
        if self.mtp_depth:
            changes.update(mtp_depth=1)
        if self.attn_period:
            changes.update(attn_period=min(self.attn_period, 2),
                           moe_period=min(self.moe_period, 2) if self.moe_period else 0)
        return dataclasses.replace(self, **changes)


def _param_count(cfg: ArchConfig, active_only: bool) -> int:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    n = 0
    # embeddings (+ untied head)
    n += cfg.padded_vocab * d
    if not cfg.tie_embeddings:
        n += cfg.padded_vocab * d

    def attn_params() -> int:
        if cfg.attention == "mla":
            p = d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.num_heads * (
                cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
            p += d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
            p += cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)
            p += cfg.num_heads * cfg.v_head_dim * d
            return p
        q = d * cfg.num_heads * hd
        kv = 2 * d * cfg.num_kv_heads * hd
        o = cfg.num_heads * hd * d
        b = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd if cfg.qkv_bias else 0
        return q + kv + o + b

    def dense_ffn(width: int) -> int:
        if cfg.act == "silu":
            return 3 * d * width
        return 2 * d * width

    def moe_ffn() -> int:
        per = 3 * d * cfg.moe_d_ff  # experts use SwiGLU
        router = d * cfg.num_experts
        if active_only:
            k = cfg.num_experts_per_tok + cfg.num_shared_experts
            return router + k * per
        return router + (cfg.num_experts + cfg.num_shared_experts) * per

    def ssm_params() -> int:
        di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        p = d * (2 * di + 2 * ns + nh)     # in_proj: z, x, B, C, dt
        p += cfg.ssm_conv * (di + 2 * ns)  # depthwise conv over x, B, C
        p += nh * 2                        # A_log, D
        p += di * d                        # out_proj
        p += di                            # gated norm
        return p

    L = cfg.num_layers
    if cfg.family == "ssm":
        n += L * ssm_params() + L * 2 * d  # + norms
        return n
    if cfg.is_hybrid:
        for i in range(L):
            is_attn = (i % cfg.attn_period) == (cfg.attn_period // 2)
            n += attn_params() if is_attn else ssm_params()
            is_moe = cfg.moe_period and (i % cfg.moe_period == cfg.moe_period - 1)
            n += moe_ffn() if is_moe else dense_ffn(cfg.d_ff)
            n += 2 * d
        return n
    # plain transformer families (dense / moe / audio / vlm)
    dense_layers = cfg.first_k_dense if cfg.uses_moe else L
    moe_layers = L - dense_layers if cfg.uses_moe else 0
    per_dense = attn_params() + dense_ffn(cfg.d_ff if cfg.d_ff else cfg.moe_d_ff) + 2 * d
    per_moe = attn_params() + moe_ffn() + 2 * d
    n += dense_layers * per_dense + moe_layers * per_moe
    if cfg.is_encoder_decoder:
        # encoder layers + decoder cross-attention
        enc = cfg.num_encoder_layers * (attn_params() + dense_ffn(cfg.d_ff) + 2 * d)
        xattn = L * (attn_params() + d)
        n += enc + xattn
    if cfg.mtp_depth:
        # MTP head: concat-proj + norm + one dense block (see Model._mtp_loss)
        n += cfg.mtp_depth * (2 * d * d + d + per_dense)
    return n


# ----------------------------------------------------------------------
# Shapes assigned to the LM pool (identical for all 10 archs).
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs, and if not, why (recorded in docs)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k-token decode is O(L^2)/unbounded KV (skip per brief)"
    return True, ""
