"""whisper-large-v3 [audio] — encoder-decoder; mel+conv frontend STUBBED.

Source: Whisper [arXiv:2212.04356].
Decoder: 32L d_model=1280 20H (kv=20, MHA) d_ff=5120 vocab=51866.
Encoder: 32L transformer backbone over 1500 precomputed frame embeddings
(the conv feature extractor is the one allowed stub; ``make_batch``
provides (batch, 1500, 1280) frame embeddings).

``long_500k`` is SKIPPED for this arch (see DESIGN.md §9): the decoder is
architecturally capped at 448 tokens and the family has no long-context
decode mode.
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51_866,
    head_dim=64,
    activation="gelu",
    gated_mlp=False,       # Whisper uses a plain GELU MLP
    norm_eps=1e-5,
    use_bias=True,
    tie_embeddings=True,
    encoder=EncoderConfig(n_layers=32, n_heads=20, d_ff=5120,
                          n_frontend_tokens=1500, d_frontend=1280),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="audio",
        source=CONFIG.source,
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=512,
        head_dim=32,
        activation="gelu",
        norm_eps=1e-5,
        use_bias=True,
        tie_embeddings=True,
        encoder=EncoderConfig(n_layers=2, n_heads=4, d_ff=256,
                              n_frontend_tokens=24, d_frontend=128),
    )
