"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.

Source: Mamba-2 [arXiv:2405.21060].
48L d_model=2048 d_ff=0 vocab=50280, ssm_state=128.
d_inner = 2*d_model = 4096, head_dim 64 -> 64 SSD heads.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=48,
    d_model=2048,
    n_heads=64,            # SSD heads = d_inner / head_dim
    n_kv_heads=64,
    d_ff=0,                # attention-free, no separate MLP block
    vocab=50_280,
    head_dim=64,
    activation="silu",
    norm_eps=1e-5,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, head_dim=64, n_groups=1,
                  expand=2, chunk=256),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        source=CONFIG.source,
        n_layers=2,
        d_model=128,
        n_heads=4,             # d_inner 256 / head_dim 64
        n_kv_heads=4,
        d_ff=0,
        vocab=512,
        head_dim=64,
        activation="silu",
        norm_eps=1e-5,
        tie_embeddings=True,
        ssm=SSMConfig(d_state=32, d_conv=4, head_dim=64, n_groups=1,
                      expand=2, chunk=32),
    )
