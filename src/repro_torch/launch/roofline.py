"""Roofline terms of a dry-run step (``repro.launch.roofline``'s counterpart).

compute    = product FLOPs / PEAK_FLOPS_BF16             (per device)
memory     = bytes         / HBM_BW                      (per device)
collective = coll_bytes    / (NVLINK_LINK_BW x links-used)

The constants are the NVIDIA H100 SXM5 80 GB's at its 700 W limit, from
its datasheet: 989 TFLOP/s dense bf16 and fp16 on the tensor cores, 67
TFLOP/s fp32, 3.35 TB/s of HBM3, and 18 NVLink 4 links of 25 GB/s each way.
They are the card's published peaks, so every time computed from them is
an estimate, never a measurement.  A mesh wider than one NVLink domain of
8 cards crosses the network between hosts, which is slower; the single
collective term, like the reference's over its ICI links, does not model
that.

The analyser (``launch.op_analysis``) counts a rank's own operations, so
FLOPs and bytes are per device; the whole job's are those times the chips.
MODEL_FLOPS = 6*N*D for training and 2*N*D for inference, N the active
parameters without the embeddings, D the tokens of a step.  This module
also holds the shape-only cost of each kernel op, which the analyser
counts in place of the launch it cannot see into.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs.base import ArchConfig, ShapeSpec

# Dense products a second, per card, by operand dtype.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
PEAK_FLOPS_BF16 = PEAK_FLOPS[torch.bfloat16]
HBM_BW = 3.35e12  # bytes/s per card
NVLINK_LINK_BW = 25e9  # bytes/s per link, each way
NVLINK_LINKS_PER_CHIP = 18


def param_counts(cfg: ArchConfig) -> dict:
    """(total, expert, embedding) parameter counts from ``lm.param_specs``:
    experts are ``*.moe.wg|wu|wd``, embeddings ``embed`` and ``lm_head``."""
    from ..models import lm

    total = expert = embed = 0
    for name, (shape, _) in lm.param_specs(cfg).items():
        names = name.split(".")
        n = 1
        for d in shape:
            n *= d
        total += n
        if "moe" in names and names[-1] in ("wg", "wu", "wd"):
            expert += n
        if names[-1] in ("embed", "lm_head"):
            embed += n
    return {"total": total, "expert": expert, "embedding": embed}


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """6*N*D (training) / 2*N*D (inference), N = active non-embedding params."""
    counts = param_counts(cfg)
    n_active = counts["total"] - counts["embedding"]
    if cfg.n_experts:
        n_active -= counts["expert"] * (1.0 - cfg.top_k / cfg.n_experts)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        factor = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        factor = 2.0
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        factor = 2.0
    return factor * n_active * tokens


# --- the kernel ops' costs, from their shapes alone ----------------------------


def _pairs_at_most(t: int, Sq: int, Sk: int) -> int:
    """The (q, k) in [0, Sq) x [0, Sk) with q - k <= t: rows q <= t see all
    Sk keys, rows q > t the Sk + t - q keys k >= q - t while that is > 0."""
    full = min(max(t + 1, 0), Sq)
    a, b = max(t + 1, 0), min(Sq, t + Sk)
    n = max(b - a, 0)
    return full * Sk + n * (Sk + t) - (a + b - 1) * n // 2


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the attention mask keeps, in closed form: the
    count of ``kernels.ref.attention_mask(Sq, Sk, causal, window)``.  Query
    q sees key k < Sk with q - k >= 0 (causal) and q - k < window (window >
    0), positions counted from 0 for both."""
    hi = window - 1 if window > 0 else Sq - 1
    lo = 0 if causal else -Sk
    return _pairs_at_most(hi, Sq, Sk) - _pairs_at_most(lo - 1, Sq, Sk)


def attention_flops(B: int, H: int, D: int, Sq: int, Sk: int, causal: bool, window: int,
                    backward: bool = False) -> float:
    """The attention's product FLOPs over the pairs its mask keeps: 4·B·H·D
    a pair forward (QKᵀ and PV), 10 backward (S and dP again, dV, dQ, dK)."""
    return (10.0 if backward else 4.0) * B * H * D * attention_pairs(Sq, Sk, causal, window)


def grouped_matmul_flops(E: int, C: int, D: int, F: int, products: int = 1) -> float:
    """2·E·C·D·F a product: one forward, one each for dx and dw backward."""
    return 2.0 * E * C * D * F * products


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float  # whole job
    hlo_bytes: float  # whole job
    collective_bytes: float  # per-device program
    model_flops: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / product FLOPs — remat/redundancy waste detector."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def step_time_s(self) -> float:
        """Roofline-optimistic step time: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline-optimistic step time."""
        denom = self.step_time_s * self.chips * PEAK_FLOPS_BF16
        return self.model_flops / denom if denom else 0.0

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes_per_dev": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_fraction": self.useful_fraction,
            "step_time_s": self.step_time_s,
            "mfu": self.mfu,
            "chips": self.chips,
        }


def roofline(
    analysis: dict,
    coll_bytes_per_dev: float,
    chips: int,
    cfg: ArchConfig,
    shape: ShapeSpec,
    links_used: int = NVLINK_LINKS_PER_CHIP,
) -> RooflineTerms:
    """The terms of one rank's step from ``op_analysis``'s per-device
    ``flops`` and ``bytes``."""
    flops_dev = float(analysis.get("flops", 0.0))
    bytes_dev = float(analysis.get("bytes", 0.0))
    return RooflineTerms(
        compute_s=flops_dev / PEAK_FLOPS_BF16,
        memory_s=bytes_dev / HBM_BW,
        collective_s=coll_bytes_per_dev / (NVLINK_LINK_BW * links_used),
        hlo_flops=flops_dev * chips,
        hlo_bytes=bytes_dev * chips,
        collective_bytes=coll_bytes_per_dev,
        model_flops=model_flops(cfg, shape),
        chips=chips,
    )
