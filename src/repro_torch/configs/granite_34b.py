"""Granite-34B-Code [arXiv:2405.04324; hf] — dense llama-arch, MQA (kv=1)."""

from .base import ArchConfig, register

GRANITE_34B = register(
    ArchConfig(
        name="granite-34b",
        family="dense",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab=49152,
        head_dim=128,
        source="arXiv:2405.04324",
    )
)
