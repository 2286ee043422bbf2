"""HuBERT-XLarge [arXiv:2106.07447; unverified] — encoder-only audio
transformer (w2v2 arch).  Modality frontend stubbed: ``input_specs`` provides
precomputed frame embeddings (B, frames, d_model); targets are masked-frame
cluster ids over a 504-way codebook."""

from .base import ArchConfig, register

HUBERT_XLARGE = register(
    ArchConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab=504,
        head_dim=80,
        is_encoder=True,
        source="arXiv:2106.07447",
    )
)
