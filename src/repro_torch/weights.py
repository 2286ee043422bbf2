"""Moves the JAX package's parameters into the port's modules.

The reference keeps an LM's layers stacked along a leading ``n_layers``
axis (``blocks.attn.{wq,wk,wv,wo,norm}``, then ``blocks.mlp.{wg,wu,wd,norm}``
or, in the MoE family, ``blocks.moe.{router,wg,wu,wd,norm}``); the port has
one module per layer.  The input is that pytree with numpy leaves
(``jax.tree.map(np.asarray, p)``), so this module needs neither JAX nor
``ml_dtypes``.
"""

from __future__ import annotations

import numpy as np
import torch

from .configs.base import ArchConfig, torch_dtype
from .models.transformer import require_ported


def params_from_jax(np_params: dict, cfg: ArchConfig) -> dict[str, torch.Tensor]:
    """A ``state_dict`` for ``models.transformer.Transformer`` (CPU tensors)."""
    require_ported(cfg)
    dt = torch_dtype(cfg.param_dtype)

    def tensor(a, dtype=dt) -> torch.Tensor:
        # JAX's bfloat16 arrives as an ml_dtypes dtype torch cannot take;
        # float32 holds every bf16/fp16 value exactly.
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np.float32))).to(dtype)

    sd = {"embed": tensor(np_params["embed"]), "final_norm": tensor(np_params["final_norm"])}
    if "lm_head" in np_params:
        sd["lm_head"] = tensor(np_params["lm_head"])
    blocks = np_params["blocks"]
    for part in ("attn", "mlp", "moe"):
        for name, stacked in blocks.get(part, {}).items():
            if len(stacked) != cfg.n_layers:
                raise ValueError(f"blocks.{part}.{name}: {len(stacked)} layers, want {cfg.n_layers}")
            # init_moe keeps the router in fp32 whatever param_dtype is.
            leaf_dt = torch.float32 if (part, name) == ("moe", "router") else dt
            for i in range(cfg.n_layers):
                sd[f"blocks.{i}.{part}.{name}"] = tensor(stacked[i], leaf_dt)
    return sd
