"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2 rec : 1 attn.

Source: Griffin / RecurrentGemma [arXiv:2402.19427].
38L d_model=4096 16H (GQA kv=1 = MQA) d_ff=12288 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig, RecurrentConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256_000,
    head_dim=256,
    activation="gelu",
    tie_embeddings=True,
    logit_softcap=30.0,
    recurrent=RecurrentConfig(
        lru_width=4096,
        d_conv=4,
        block_pattern=("rec", "rec", "attn"),
        local_window=2048,
    ),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke",
        family="hybrid",
        source=CONFIG.source,
        n_layers=3,                       # one full (rec, rec, attn) group
        d_model=128,
        n_heads=4,
        n_kv_heads=1,
        d_ff=256,
        vocab=512,
        head_dim=32,
        activation="gelu",
        tie_embeddings=True,
        logit_softcap=30.0,
        recurrent=RecurrentConfig(
            lru_width=128, d_conv=4,
            block_pattern=("rec", "rec", "attn"), local_window=64,
        ),
    )
