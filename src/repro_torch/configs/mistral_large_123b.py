"""mistral-large-123b [dense] — GQA decoder.

Source: [hf:mistralai/Mistral-Large-Instruct-2407].
88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    n_layers=88,
    d_model=12_288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28_672,
    vocab=32_768,
    head_dim=128,
    activation="silu",
    norm_eps=1e-5,
    rope_theta=1_000_000.0,
    use_bias=False,
    decode_window=4096,   # beyond-paper SWA decode variant for long_500k
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-smoke",
        family="dense",
        source=CONFIG.source,
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        head_dim=16,
        activation="silu",
        norm_eps=1e-5,
        decode_window=64,
    )
