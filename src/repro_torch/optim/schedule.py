"""LR schedules (``repro.optim.schedule``'s counterpart): functions of an int
step that return a Python float, computed in float32 as the reference
computes them.  minicpm-2b trains with WSD (warmup-stable-decay,
arXiv:2404.06395); the others default to cosine."""

from __future__ import annotations

import math

import numpy as np


def constant(lr: float):
    return lambda step: float(np.float32(lr))


def linear_warmup(lr: float, warmup: int):
    def fn(step: int) -> float:
        s = np.float32(step)
        return float(np.float32(lr) * np.minimum(1.0, (s + 1) / max(warmup, 1)))

    return fn


def cosine(lr: float, total_steps: int, warmup: int = 100, final_frac: float = 0.1):
    def fn(step: int) -> float:
        s = np.float32(step)
        warm = np.minimum(1.0, (s + 1) / max(warmup, 1))
        prog = np.clip((s - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + np.cos(np.float32(math.pi) * prog))
        return float(np.float32(lr) * warm * cos)

    return fn


def wsd(lr: float, total_steps: int, warmup_frac: float = 0.01,
        decay_frac: float = 0.1, final_frac: float = 0.01):
    """Warmup-Stable-Decay: linear warmup, long constant plateau, short
    linear decay tail."""
    warmup = max(1, int(total_steps * warmup_frac))
    decay_start = int(total_steps * (1 - decay_frac))

    def fn(step: int) -> float:
        s = np.float32(step)
        warm = np.minimum(1.0, (s + 1) / warmup)
        decay_prog = np.clip((s - decay_start) / max(total_steps - decay_start, 1), 0.0, 1.0)
        decay = 1.0 - (1.0 - final_frac) * decay_prog
        return float(np.float32(lr) * warm * decay)

    return fn
