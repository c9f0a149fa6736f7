"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

Source: Mixtral [arXiv:2401.04088].
56L d_model=6144 48H (GQA kv=8) d_expert=16384 vocab=32768.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    source="arXiv:2401.04088",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,           # per-expert hidden
    vocab=32_768,
    head_dim=128,
    activation="silu",
    rope_theta=1_000_000.0,
    window=4096,           # native SWA -> long_500k runs natively
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=16_384,
                  capacity_factor=1.25, router_aux_weight=0.01),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke",
        family="moe",
        source=CONFIG.source,
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        head_dim=32,
        activation="silu",
        window=64,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=128,
                      capacity_factor=1.5, router_aux_weight=0.01),
    )
