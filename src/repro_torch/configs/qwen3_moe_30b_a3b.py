"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — MoE, 128 experts top-8."""

from .base import ArchConfig, register

QWEN3_MOE_30B = register(
    ArchConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_ff=768,  # per-expert ffn width
        vocab=151936,
        head_dim=128,  # hf config head_dim (decoupled from d_model/n_heads)
        n_experts=128,
        top_k=8,
        source="hf:Qwen/Qwen3-30B-A3B",
    )
)
