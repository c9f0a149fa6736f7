"""internvl2-2b [vlm] — InternViT (STUB frontend) + InternLM2 decoder.

Source: InternVL2 [arXiv:2404.16821].
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
"""
from repro_torch.configs.base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    source="arXiv:2404.16821",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92_553,
    activation="silu",
    decode_window=4096,   # beyond-paper SWA decode variant for long_500k
    vlm=VLMConfig(n_visual_tokens=256, d_visual=1024),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke",
        family="vlm",
        source=CONFIG.source,
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        activation="silu",
        decode_window=64,
        vlm=VLMConfig(n_visual_tokens=16, d_visual=64),
    )
