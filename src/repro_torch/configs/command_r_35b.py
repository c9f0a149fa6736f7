"""command-r-35b [dense] — GQA, no-bias decoder.

Source: [hf:CohereForAI/c4ai-command-r-v01].
40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_528,
    vocab=256_000,
    head_dim=128,
    activation="silu",
    norm_eps=1e-5,
    rope_theta=8_000_000.0,
    use_bias=False,
    tie_embeddings=True,
    decode_window=4096,   # beyond-paper SWA decode variant for long_500k
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-smoke",
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
        tie_embeddings=True,
        decode_window=64,
    )
