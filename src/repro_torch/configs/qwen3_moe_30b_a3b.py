"""qwen3-moe-30b-a3b [moe] — 128 experts, top-8.

Source: [hf:Qwen/Qwen3-30B-A3B].
48L d_model=2048 32H (GQA kv=4) d_expert=768 vocab=151936, head_dim 128.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,              # per-expert hidden (moe_intermediate_size)
    vocab=151_936,
    head_dim=128,
    activation="silu",
    rope_theta=1_000_000.0,
    decode_window=4096,    # beyond-paper SWA decode variant for long_500k
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=768,
                  capacity_factor=1.25, router_aux_weight=0.001),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke",
        family="moe",
        source=CONFIG.source,
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=64,
        vocab=512,
        head_dim=32,
        activation="silu",
        decode_window=64,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64,
                      capacity_factor=1.5, router_aux_weight=0.001),
    )
