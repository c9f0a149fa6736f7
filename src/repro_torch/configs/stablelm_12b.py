"""stablelm-12b [dense] — GQA decoder.

Source: [hf:stabilityai/stablelm-2-1_6b] (family scaled to 12B).
40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13_824,
    vocab=100_352,
    head_dim=160,
    activation="silu",
    norm_eps=1e-5,
    use_bias=False,
    decode_window=4096,   # beyond-paper SWA decode variant for long_500k
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke",
        family="dense",
        source=CONFIG.source,
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        head_dim=32,
        activation="silu",
        norm_eps=1e-5,
        decode_window=64,
    )
