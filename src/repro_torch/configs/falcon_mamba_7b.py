"""Falcon-Mamba-7B [arXiv:2410.05355; unverified] — pure Mamba-1 SSM,
attention-free; d_inner = 2 * d_model, ssm_state = 16."""

from .base import ArchConfig, register

FALCON_MAMBA_7B = register(
    ArchConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=65024,
        ssm_state=16,
        d_conv=4,
        expand=2,
        dt_rank=256,  # d_model / 16
        source="arXiv:2410.05355",
    )
)
