"""MiniCPM-2B [arXiv:2404.06395; hf] — dense llama-like, WSD schedule."""

from .base import ArchConfig, register

MINICPM_2B = register(
    ArchConfig(
        name="minicpm-2b",
        family="dense",
        n_layers=40,
        d_model=2304,
        n_heads=36,
        n_kv_heads=36,
        d_ff=5760,
        vocab=122753,
        head_dim=64,
        tie_embeddings=True,
        schedule="wsd",
        source="arXiv:2404.06395",
    )
)
