"""Qwen3-235B-A22B [hf:Qwen/Qwen3-235B-A22B] — MoE, 128 experts top-8."""

from .base import ArchConfig, register

QWEN3_MOE_235B = register(
    ArchConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        d_ff=1536,  # per-expert ffn width
        vocab=151936,
        head_dim=128,
        n_experts=128,
        top_k=8,
        source="hf:Qwen/Qwen3-30B-A3B (235B sibling)",
    )
)
