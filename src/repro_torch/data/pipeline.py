"""Deterministic synthetic data pipeline (``repro.data.pipeline``'s copy).

Stateless: ``batch_for_step(step)`` derives every batch from (seed, step), so
checkpoint/restart never needs data-state checkpoints: restarting at step k
regenerates exactly the batch stream from k.  Batches are numpy arrays,
bitwise the reference's; the training loop moves each one to the device.
A background prefetch thread keeps ``depth`` batches ready.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

from ..configs.base import ArchConfig, ShapeSpec


@dataclass(frozen=True)
class DataSpec:
    cfg: ArchConfig
    shape: ShapeSpec
    seed: int = 0
    # Multi-host sharding: this process owns batch rows
    # [process_index::process_count].
    process_index: int = 0
    process_count: int = 1


def batch_for_step(spec: DataSpec, step: int) -> dict:
    """Deterministic batch for a global step (numpy, host-side)."""
    cfg, shape = spec.cfg, spec.shape
    rng = np.random.default_rng(np.uint64(spec.seed * 1_000_003 + step))
    B, S = shape.global_batch, shape.seq_len
    nb = len(range(spec.process_index, B, spec.process_count))

    if cfg.family == "audio":
        return {
            "frames": rng.standard_normal((nb, S, cfg.d_model), dtype=np.float32),
            "labels": rng.integers(0, cfg.vocab, (nb, S), dtype=np.int32),
        }
    batch = {"tokens": rng.integers(0, cfg.vocab, (nb, S), dtype=np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (nb, cfg.img_tokens, cfg.d_model), dtype=np.float32
        )
    return batch


class Prefetcher:
    """Background-thread batch prefetch with bounded depth."""

    def __init__(self, spec: DataSpec, start_step: int, depth: int = 2):
        self.spec = spec
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = batch_for_step(self.spec, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
