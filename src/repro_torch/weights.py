"""Moves the JAX package's parameters into the port's modules.

The reference keeps a dense LM's layers stacked along a leading
``n_layers`` axis (``blocks.attn.{wq,wk,wv,wo,norm}``,
``blocks.mlp.{wg,wu,wd,norm}``); the port has one module per layer.  The
input is that pytree with numpy leaves (``jax.tree.map(np.asarray, p)``),
so this module needs neither JAX nor ``ml_dtypes``.
"""

from __future__ import annotations

import numpy as np
import torch

from .configs.base import ArchConfig, torch_dtype
from .models.transformer import require_dense


def params_from_jax(np_params: dict, cfg: ArchConfig) -> dict[str, torch.Tensor]:
    """A ``state_dict`` for ``models.transformer.Transformer`` (CPU tensors)."""
    require_dense(cfg)
    dt = torch_dtype(cfg.param_dtype)

    def tensor(a) -> torch.Tensor:
        # JAX's bfloat16 arrives as an ml_dtypes dtype torch cannot take;
        # float32 holds every bf16/fp16 value exactly.
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np.float32))).to(dt)

    sd = {"embed": tensor(np_params["embed"]), "final_norm": tensor(np_params["final_norm"])}
    if "lm_head" in np_params:
        sd["lm_head"] = tensor(np_params["lm_head"])
    blocks = np_params["blocks"]
    for part in ("attn", "mlp"):
        for name, stacked in blocks[part].items():
            if len(stacked) != cfg.n_layers:
                raise ValueError(f"blocks.{part}.{name}: {len(stacked)} layers, want {cfg.n_layers}")
            for i in range(cfg.n_layers):
                sd[f"blocks.{i}.{part}.{name}"] = tensor(stacked[i])
    return sd
