"""DLRM (paper §2.1/§5, List 1) — the paper's flagship workload.  Used by the
examples and benchmarks (recsys family: its shapes are batch-only, outside
the LM shape grid)."""

from .base import ArchConfig, register

DLRM_PAPER = register(
    ArchConfig(
        name="dlrm-paper",
        family="recsys",
        n_layers=8,  # dense stack
        d_model=2048,
        n_heads=0,
        n_kv_heads=0,
        d_ff=4096,  # feature-layer width
        vocab=0,
        source="paper List 1 (§5.3); github.com/facebookresearch/dlrm",
    )
)
