"""Architecture configs + input shapes.

One :class:`ArchConfig` covers every assigned family; per-arch files
instantiate the exact published configuration and register it.  ``smoke()``
returns the reduced same-family config used by CPU tests.  Input and cache
specs are plain ``(shape, torch dtype)`` tuples: they allocate nothing.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable

import torch


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The assigned LM shape set (identical for all 10 archs, with per-family
# skips recorded in shape_applicability()).
TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # VLM (cross-attention image layers; frontend stubbed)
    cross_attn_every: int = 0  # every k-th layer is a cross-attn block
    img_tokens: int = 0
    # Hybrid (RG-LRU + local attention)
    block_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    tail_pattern: tuple[str, ...] = ()
    attn_window: int = 0  # sliding window for local attention
    lru_width: int = 0
    # SSM (mamba1)
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0
    # Encoder-only (audio): no causal mask, no decode shapes
    is_encoder: bool = False
    # Schedule hint (minicpm uses WSD)
    schedule: str = "cosine"
    # Numerics
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    # notes for DESIGN/EXPERIMENTS
    source: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model if self.family == "ssm" else (
            self.lru_width or self.d_model
        )

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // max(self.n_heads, 1))),
            head_dim=16,
            d_ff=128,
            vocab=256,
        )
        if self.family == "moe":
            # capacity 4.0 => dropless at smoke scale (keeps prefill/decode
            # numerically identical to the full forward).
            small.update(n_experts=4, top_k=2, d_ff=32, capacity_factor=4.0)
        if self.family == "vlm":
            small.update(cross_attn_every=2, img_tokens=8, n_layers=4)
        if self.family == "hybrid":
            small.update(lru_width=64, attn_window=16, n_layers=5,
                         tail_pattern=("rec", "rec"))
        if self.family == "ssm":
            small.update(ssm_state=8, dt_rank=8, n_layers=2)
        if self.n_kv_heads == self.n_heads:
            small["n_kv_heads"] = small["n_heads"]
        if self.n_kv_heads == 1:
            small["n_kv_heads"] = 1
        return replace(self, **small)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def all_configs() -> dict[str, ArchConfig]:
    if not _REGISTRY:
        _load_all()
    return dict(_REGISTRY)


def _load_all() -> None:
    from importlib import import_module

    for mod in (
        "minicpm_2b",
        "deepseek_coder_33b",
        "granite_8b",
        "granite_34b",
        "qwen3_moe_30b_a3b",
        "qwen3_moe_235b_a22b",
        "llama32_vision_11b",
        "recurrentgemma_9b",
        "falcon_mamba_7b",
        "hubert_xlarge",
        "dlrm",
    ):
        import_module(f"repro_torch.configs.{mod}")


# ---------------------------------------------------------------------------
# Shape applicability (skips recorded in DESIGN.md §4)
# ---------------------------------------------------------------------------


def shape_applicability(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for one (arch, shape) cell."""
    if cfg.is_encoder and shape.kind == "decode":
        return False, "encoder-only arch: no autoregressive decode step"
    if shape.name == "long_500k":
        sub_quadratic = cfg.family in ("ssm", "hybrid")
        if not sub_quadratic:
            return False, "pure full-attention arch: O(L^2) at 524k infeasible"
    return True, ""


def runnable_cells() -> list[tuple[ArchConfig, ShapeSpec]]:
    cells = []
    for cfg in all_configs().values():
        if cfg.family == "recsys":  # paper's DLRM: separate shape system
            continue
        for shape in ALL_SHAPES:
            ok, _ = shape_applicability(cfg, shape)
            if ok:
                cells.append((cfg, shape))
    return cells


# ---------------------------------------------------------------------------
# Input specs ((shape, dtype) tuples; no allocation) — DESIGN.md §5
# ---------------------------------------------------------------------------


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config's dtype name (``"bfloat16"`` etc.)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Model inputs for one cell as ``(shape, dtype)`` tuples.

    train:   tokens (B, S) i32 (+ image_embeds / frames for vlm/audio)
    prefill: tokens (B, S) i32
    decode:  token (B,) i32, pos () i32, cache pytree (family-specific)
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    act = torch_dtype(cfg.activation_dtype)

    if cfg.family == "audio":
        batch = {
            "frames": ((B, S, cfg.d_model), act),
            "labels": ((B, S), i32),
        }
        return batch

    batch: dict = {"tokens": ((B, S), i32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = ((B, cfg.img_tokens, cfg.d_model), act)

    if shape.kind == "decode":
        batch = {
            "token": ((B,), i32),
            "pos": ((), i32),
            "cache": cache_specs(cfg, B, S),
        }
        if cfg.family == "vlm":
            batch["image_embeds"] = (
                (B, cfg.img_tokens, cfg.d_model), act
            )
    return batch


def cache_specs(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """Decoding state for one model (stacked over layers)."""
    act = torch_dtype(cfg.activation_dtype)
    hd = cfg.hd

    if cfg.family == "ssm":
        return {
            "conv": (
                (cfg.n_layers, batch, cfg.d_conv - 1, cfg.d_inner), act
            ),
            "ssm": (
                (cfg.n_layers, batch, cfg.d_inner, cfg.ssm_state), torch.float32
            ),
        }
    if cfg.family == "hybrid":
        n_blocks = cfg.n_layers // len(cfg.block_pattern) if cfg.block_pattern else 0
        n_rec_main = n_blocks * sum(1 for k in cfg.block_pattern if k == "rec")
        n_attn = n_blocks * sum(1 for k in cfg.block_pattern if k == "attn")
        n_rec_tail = sum(1 for k in cfg.tail_pattern if k == "rec")
        window = min(cfg.attn_window, seq_len)
        return {
            "lru": (
                (n_rec_main + n_rec_tail, batch, cfg.d_inner), torch.float32
            ),
            "conv": (
                (n_rec_main + n_rec_tail, batch, 3, cfg.d_inner), act
            ),
            "k": ((n_attn, batch, cfg.n_kv_heads, window, hd), act),
            "v": ((n_attn, batch, cfg.n_kv_heads, window, hd), act),
        }
    # dense / moe / vlm transformers: full KV cache per self-attn layer.
    n_self = cfg.n_layers
    specs = {}
    if cfg.family == "vlm" and cfg.cross_attn_every:
        n_cross = cfg.n_layers // cfg.cross_attn_every
        n_self = cfg.n_layers - n_cross
        specs["xk"] = (
            (n_cross, batch, cfg.n_kv_heads, cfg.img_tokens, hd), act
        )
        specs["xv"] = (
            (n_cross, batch, cfg.n_kv_heads, cfg.img_tokens, hd), act
        )
    specs["k"] = ((n_self, batch, cfg.n_kv_heads, seq_len, hd), act)
    specs["v"] = ((n_self, batch, cfg.n_kv_heads, seq_len, hd), act)
    return specs
