"""DeepSeek-Coder-33B [arXiv:2401.14196; hf] — dense llama-arch, GQA kv=8."""

from .base import ArchConfig, register

DEEPSEEK_CODER_33B = register(
    ArchConfig(
        name="deepseek-coder-33b",
        family="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=19200,
        vocab=32256,
        head_dim=128,
        source="arXiv:2401.14196",
    )
)
