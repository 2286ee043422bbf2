"""RecurrentGemma-9B [arXiv:2402.19427; unverified] — Griffin: RG-LRU
recurrent blocks + local (sliding-window) attention, pattern 2 recurrent : 1
attention.  38 layers = 12 x (rec, rec, attn) + (rec, rec) tail.
"""

from .base import ArchConfig, register

RECURRENTGEMMA_9B = register(
    ArchConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        d_ff=12288,
        vocab=256000,
        head_dim=256,
        block_pattern=("rec", "rec", "attn"),
        tail_pattern=("rec", "rec"),
        attn_window=2048,
        lru_width=4096,
        source="arXiv:2402.19427",
    )
)
