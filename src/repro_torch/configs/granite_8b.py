"""Granite-8B-Code [arXiv:2405.04324; hf] — dense llama-arch, GQA kv=8."""

from .base import ArchConfig, register

GRANITE_8B = register(
    ArchConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=49152,
        head_dim=128,
        source="arXiv:2405.04324",
    )
)
