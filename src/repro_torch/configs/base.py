"""Config dataclasses for models and input shapes, plus the paper's
scheduling defaults (single source for the port).

The port's copy of ``repro.configs.base``: the same fields, defaults
and derived properties, so a config of either package describes the
same model. ``ParallelismPlan`` is not copied: nothing in either
package builds or reads it; the dry-run's resolved plans are
``sharding.plans.Plan``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# The paper's FitGpp defaults (§4.3).
PAPER_S = 4.0       # Eq. 3 grace-period weight s
PAPER_P = 1         # per-job preemption cap P (Fig. 5 sweeps it)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block config."""
    num_experts: int
    top_k: int
    d_expert: int                     # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01   # load-balance loss weight


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD config (arXiv:2405.21060)."""
    d_state: int = 128
    d_conv: int = 4
    head_dim: int = 64                # P in the SSD paper
    n_groups: int = 1                 # B/C groups
    expand: int = 2                   # d_inner = expand * d_model
    chunk: int = 256                  # SSD chunk length


@dataclass(frozen=True)
class RecurrentConfig:
    """RG-LRU / Griffin recurrent block config (arXiv:2402.19427)."""
    lru_width: int = 0                # 0 -> d_model
    d_conv: int = 4
    block_pattern: Tuple[str, ...] = ("rec", "rec", "attn")  # 1:2 attn:rec
    local_window: int = 2048


@dataclass(frozen=True)
class EncoderConfig:
    """Frontend-consuming encoder (whisper): transformer backbone only;
    the modality frontend is a stub that provides precomputed
    frame/patch embeddings (batch, n_frontend_tokens, d_frontend)."""
    n_layers: int
    n_heads: int
    d_ff: int
    n_frontend_tokens: int            # 1500 frames (whisper) / patches
    d_frontend: int                   # embedding dim provided by the stub


@dataclass(frozen=True)
class VLMConfig:
    """VLM prefix config; the vision tower is a stub providing embeddings."""
    n_visual_tokens: int = 256
    d_visual: int = 1024              # projector input dim (stub output)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    source: str                       # citation

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    activation: str = "silu"          # silu | gelu | sq_relu
    gated_mlp: bool = True            # SwiGLU/GeGLU vs plain 2-matrix MLP
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    use_bias: bool = False
    tie_embeddings: bool = False
    logit_softcap: float = 0.0        # 0 = disabled (gemma-style cap)

    # Attention variants
    window: int = 0                   # 0 = full attention; >0 = native SWA
    decode_window: int = 0            # beyond-paper SWA decode variant used
                                      # only for long_500k on full-attn archs

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    encoder: Optional[EncoderConfig] = None
    vlm: Optional[VLMConfig] = None

    dtype: str = "bfloat16"           # compute/params dtype
    remat: str = "full"               # none | full | dots

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}

