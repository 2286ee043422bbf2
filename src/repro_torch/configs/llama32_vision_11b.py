"""Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

Transformer backbone only: every 5th layer is a cross-attention block over
precomputed patch embeddings (modality frontend is a stub; ``input_specs``
provides (B, img_tokens, d_model) embeddings directly).
"""

from .base import ArchConfig, register

LLAMA32_VISION_11B = register(
    ArchConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=128256,
        head_dim=128,
        cross_attn_every=5,  # 8 cross-attn blocks of 40 layers
        img_tokens=1601,  # 1 CLS + 40x40 patches
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    )
)
