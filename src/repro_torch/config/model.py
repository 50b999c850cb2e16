"""Architecture configuration.

One ``ModelConfig`` describes any member of the supported LM families:

* ``dense``   — standard decoder-only transformer (GQA/MQA, RoPE, gated MLP)
* ``moe``     — dense attention + mixture-of-experts FFN (top-k routing,
                optional shared/dense-residual experts, GShard-style dispatch)
* ``ssm``     — attention-free RWKV6 (Finch) stack
* ``hybrid``  — Hymba-style parallel attention + Mamba heads per block
* ``audio``   — encoder-only transformer over precomputed frame embeddings
* ``vlm``     — decoder with interleaved cross-attention image layers

The config is deliberately explicit (no derived magic): every field that a
block builder reads is spelled out here so that ``src/repro/configs/<arch>.py``
files are an exact transcription of the assignment table.

A copy of the JAX package's ``config/model.py``; the analytic parameter
counts are left out (the port counts the tensors it builds).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

Family = str  # "dense" | "moe" | "ssm" | "hybrid" | "audio" | "vlm"


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 2
    # Expert FFN hidden size (may differ from cfg.d_ff which is the dense FFN).
    expert_d_ff: int = 0
    # Arctic: a dense FFN runs in parallel with the MoE experts on every layer.
    dense_residual: bool = False
    # DeepSeek-style always-on shared experts (0 = none).
    num_shared_experts: int = 0
    # GShard dispatch parameters.
    capacity_factor: float = 1.25
    # Tokens are dispatched in groups of this size to bound the one-hot
    # dispatch tensor (see models/moe.py); 0 = single group.
    group_size: int = 4096
    # Load-balance auxiliary loss weight.
    aux_loss_weight: float = 0.01
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM (used by the hybrid family)."""

    state_size: int = 16
    conv_width: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model/16)
    chunk_size: int = 256


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 (Finch) time-mix / channel-mix parameters."""

    head_size: int = 64
    # Low-rank adapter widths for the data-dependent mixing / decay.
    lora_rank_decay: int = 64
    lora_rank_mix: int = 32
    lora_rank_gate: int = 64
    chunk_size: int = 128


@dataclass(frozen=True)
class VisionConfig:
    """Stubbed modality frontend: precomputed patch embeddings are model input."""

    num_image_tokens: int = 1600
    cross_attn_every: int = 5  # every Nth layer is a cross-attention layer


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- normalization / activation ---
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm" | "layernorm_np" (OLMo)
    norm_eps: float = 1e-5
    activation: str = "swiglu"  # "swiglu" | "geglu" | "gelu" | "silu" | "relu2"
    use_bias: bool = False
    parallel_residual: bool = False  # attn and FFN read the same normed input
    qk_norm: bool = False  # Qwen3: RMSNorm on q/k per head

    # --- position / attention ---
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0  # StableLM2 uses 0.25
    causal: bool = True  # False for encoder-only
    sliding_window: int = 0  # 0 = full attention
    attn_logit_softcap: float = 0.0
    # Gemma scales embeddings by sqrt(d_model).
    scale_embedding: bool = False
    tie_embeddings: bool = True
    # Encoder-only models use learned absolute positions (stub frontend).
    learned_pos_embedding: bool = False
    max_position: int = 524_288

    # --- family-specific sub-configs ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    vision: Optional[VisionConfig] = None

    # --- bookkeeping ---
    # True if the architecture has a sub-quadratic sequence mechanism, i.e.
    # the long_500k shape is runnable (assignment rule).
    subquadratic: bool = False
    # Citation string straight from the assignment table.
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(
                f"{self.name}: num_heads={self.num_heads} not a multiple of "
                f"num_kv_heads={self.num_kv_heads}"
            )
        if self.family in ("moe",) and self.moe is None:
            raise ValueError(f"{self.name}: family=moe requires moe config")
        if self.family == "ssm" and self.rwkv is None:
            raise ValueError(f"{self.name}: family=ssm requires rwkv config")
        if self.family == "hybrid" and self.ssm is None:
            raise ValueError(f"{self.name}: family=hybrid requires ssm config")
        if self.family == "vlm" and self.vision is None:
            raise ValueError(f"{self.name}: family=vlm requires vision config")

    # ------------------------------------------------------------------
    @property
    def is_encoder_only(self) -> bool:
        return self.family == "audio" or not self.causal

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 so the logits/vocab dim
        shards on the model axis (hymba's 32,001 would otherwise replicate a
        4 GB fp32 logits tensor per device).  Padded columns are masked to
        -1e9 in lm_logits; every production framework does this."""
        return -(-self.vocab_size // 128) * 128

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline cross-checks),
        from the port's own ``models.param_specs``."""
        from repro_torch.models.initializers import param_specs
        from repro_torch.utils.tree import tree_leaves

        return sum(math.prod(s.shape) for s in tree_leaves(param_specs(self)))

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k experts active)."""
        total = self.param_count()
        if self.family != "moe" or self.moe is None:
            return total
        m = self.moe
        inactive = (m.num_experts - m.top_k) * self._expert_params() * self.num_layers
        return total - inactive

    def _expert_params(self) -> int:
        m = self.moe
        gated = self.activation in ("swiglu", "geglu")
        in_w = self.d_model * m.expert_d_ff * (2 if gated else 1)
        out_w = m.expert_d_ff * self.d_model
        return in_w + out_w


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Shrink a full config to something a 1-core CPU can run a step of.

    Keeps the *family machinery* (MoE routing, RWKV scan, cross-attention,
    parallel SSM heads) while cutting widths/depths/experts/vocab.
    """
    kw: dict = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        max_position=512,
    )
    if cfg.family == "vlm":
        # keep the 4-self + 1-cross group structure -> 5 layers minimum
        kw["num_layers"] = cfg.vision.cross_attn_every
        kw["vision"] = VisionConfig(num_image_tokens=8, cross_attn_every=cfg.vision.cross_attn_every)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2), expert_d_ff=32, group_size=64
        )
    if cfg.rwkv is not None:
        kw["rwkv"] = dataclasses.replace(
            cfg.rwkv, head_size=16, lora_rank_decay=8, lora_rank_mix=4, lora_rank_gate=8, chunk_size=16
        )
        kw["num_heads"] = 4  # d_model / head_size
        kw["head_dim"] = 16
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_size=4, chunk_size=16)
        kw["num_heads"] = 5 if cfg.num_heads % 2 == 1 else 4  # keep odd-head coverage
        kw["num_kv_heads"] = 1
        kw["head_dim"] = 16
        kw["d_model"] = kw["num_heads"] * 16
    if cfg.sliding_window:
        kw["sliding_window"] = 32
    return cfg.replace(**kw)
