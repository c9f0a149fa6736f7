"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP.

Source: Nemotron-4 [arXiv:2402.16819].
96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    source="arXiv:2402.16819",
    n_layers=96,
    d_model=18_432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73_728,
    vocab=256_000,
    head_dim=192,
    activation="sq_relu",
    gated_mlp=False,       # Nemotron-4 uses plain squared-ReLU MLP
    norm_eps=1e-5,
    use_bias=False,
    decode_window=4096,   # beyond-paper SWA decode variant for long_500k
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke",
        family="dense",
        source=CONFIG.source,
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=512,
        vocab=512,
        head_dim=16,
        activation="sq_relu",
        gated_mlp=False,
        norm_eps=1e-5,
        decode_window=64,
    )
