"""Checkpoints: atomic npz files and a manifest (``repro.checkpoint.ckpt``'s
counterpart, with the same on-disk layout).

A checkpoint is ``<ckpt_dir>/step-NNNNNNNN/`` holding ``params.npz``,
``opt_state.npz`` and ``manifest.json``, written into a staging dir and
moved into place with one ``os.replace``.  Trees are dicts of tensors
(``named_parameters()`` names, and the optimizer's name -> tensor maps);
keys are their paths joined by ``/``.  bf16, which numpy cannot store, is
kept as a ``uint16`` view under ``<key>::bfloat16``.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

# numpy cannot store bfloat16: it is kept as a uint16 bit view under the
# key with this tag appended.
_BF16_TAG = "::bfloat16"


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for name, leaf in tree.items():
        key = f"{prefix}{name}"
        if isinstance(leaf, dict):
            flat.update(_flatten(leaf, key + "/"))
            continue
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            flat[key + _BF16_TAG] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            flat[key] = t.numpy()
    return flat


def _unflatten_like(spec_tree, flat: dict[str, torch.Tensor], device, prefix: str = ""):
    """``spec_tree``'s structure with each leaf read from ``flat`` in the
    spec leaf's dtype, on ``device`` (else the spec leaf's device)."""
    out = {}
    for name, spec in spec_tree.items():
        key = f"{prefix}{name}"
        if isinstance(spec, dict):
            out[name] = _unflatten_like(spec, flat, device, key + "/")
            continue
        arr = flat[key]
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(
                f"checkpoint leaf {key}: shape {arr.shape} != expected {tuple(spec.shape)}"
            )
        out[name] = arr.to(device=device or spec.device, dtype=spec.dtype)
    return out


def _read(path: str) -> dict[str, torch.Tensor]:
    flat = {}
    with np.load(path) as z:
        for key in z.files:
            arr = z[key]
            if key.endswith(_BF16_TAG):
                flat[key.removesuffix(_BF16_TAG)] = (
                    torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16))
            else:
                flat[key] = torch.from_numpy(arr)
    return flat


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state=None,
                    extra: dict | None = None) -> str:
    """Atomic write: stage into a tmp dir, then rename to step-NNNNNNNN."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step-{step:08d}")
    tmp = tempfile.mkdtemp(prefix=".staging-", dir=ckpt_dir)
    try:
        np.savez(os.path.join(tmp, "params.npz"), **_flatten(params))
        if opt_state is not None:
            np.savez(os.path.join(tmp, "opt_state.npz"), **_flatten(opt_state))
        manifest = {
            "step": step,
            "time": time.time(),
            "has_opt_state": opt_state is not None,
            **(extra or {}),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def available_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step-") and os.path.exists(
            os.path.join(ckpt_dir, name, "manifest.json")
        ):
            steps.append(int(name.split("-")[1]))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_checkpoint(ckpt_dir: str, param_specs, opt_specs=None, step: int | None = None,
                    device=None):
    """Loads step ``step`` (default the latest) -> (step, params, opt_state,
    manifest).  The specs are trees of tensors shaped like what was saved;
    each loaded leaf takes its spec's dtype and lies on ``device`` (default:
    the spec leaf's).  A leaf whose shape differs raises ``ValueError``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step-{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    params = _unflatten_like(param_specs, _read(os.path.join(d, "params.npz")), device)
    opt_state = None
    if opt_specs is not None and manifest.get("has_opt_state"):
        opt_state = _unflatten_like(opt_specs, _read(os.path.join(d, "opt_state.npz")), device)
    return step, params, opt_state, manifest


def prune_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    steps = available_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step-{s:08d}"), ignore_errors=True)
