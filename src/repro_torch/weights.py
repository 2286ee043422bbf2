"""Moves the JAX package's parameters into the port's modules.

The reference keeps an LM's layers stacked along leading axes; the port has
one module per layer:

* dense, MoE and audio: ``blocks.attn.*`` and ``blocks.mlp.*`` (or
  ``blocks.moe.*``) stacked over ``n_layers`` -> ``blocks.{i}.{part}.*``
  (audio has no ``embed``);
* ``vlm`` (Llama-3.2-vision): ``blocks.self.{attn,mlp}.*`` stacked
  (n_super, inner) and ``blocks.cross.{attn,mlp}.*`` stacked (n_super,) ->
  ``blocks.{j}.{part}.*`` with layer j = k*s + r for self block r of
  super-block s and k*s + k - 1 for its cross block (k =
  ``cross_attn_every``, inner = k - 1);
* ``ssm`` (Falcon-Mamba): ``blocks.*`` stacked over ``n_layers`` ->
  ``blocks.{i}.*``;
* ``hybrid`` (Griffin): ``blocks.rec.{rec,mlp}.*`` stacked (n_blocks, 2),
  ``blocks.attn.{attn,mlp}.*`` stacked (n_blocks,) and ``tail.{rec,mlp}.*``
  stacked (len(tail_pattern),) -> ``layers.{j}.{part}.*`` with layer
  j = 3*block + r for the recurrent layers, 3*block + 2 for the attention
  layer, and 3*n_blocks + t for the tail.

DLRM (``dlrm_params_from_jax``): ``tables`` as it is, and the ``bottom`` and
``top`` lists of ``{"w", "b"}`` -> ``bottom.{i}.{w,b}`` and ``top.{i}.{w,b}``.

The input is that pytree with numpy leaves (``jax.tree.map(np.asarray, p)``),
so this module needs neither JAX nor ``ml_dtypes``.  Projections stay
``(d_in, d_out)``, as the reference keeps them.
"""

from __future__ import annotations

import numpy as np
import torch

from .configs.base import ArchConfig, torch_dtype
from .models.transformer import require_ported

# Leaves the reference initialises in fp32 whatever ``param_dtype`` is.
FP32_LEAVES = {("moe", "router"), ("mamba", "b_dt"), ("mamba", "a_log"),
               ("mamba", "d_skip"), ("rec", "lambda_p")}


def params_from_jax(np_params: dict, cfg: ArchConfig) -> dict[str, torch.Tensor]:
    """A ``state_dict`` for the module ``models.lm.init`` builds (CPU tensors)."""
    require_ported(cfg)
    dt = torch_dtype(cfg.param_dtype)

    def tensor(a, part, name) -> torch.Tensor:
        # JAX's bfloat16 arrives as an ml_dtypes dtype torch cannot take;
        # float32 holds every bf16/fp16 value exactly.
        leaf_dt = torch.float32 if (part, name) in FP32_LEAVES else dt
        # np.array keeps a 0-d leaf (the VLM's gate) 0-d; ascontiguousarray would not.
        return torch.from_numpy(np.array(np.asarray(a), dtype=np.float32)).to(leaf_dt)

    sd = {name: tensor(np_params[name], None, name)
          for name in ("embed", "final_norm", "lm_head") if name in np_params}
    blocks = np_params["blocks"]
    if cfg.family == "ssm":
        for name, stacked in blocks.items():
            _check_depth(f"blocks.{name}", stacked, cfg.n_layers)
            for i in range(cfg.n_layers):
                sd[f"blocks.{i}.{name}"] = tensor(stacked[i], "mamba", name)
        return sd
    if cfg.family == "hybrid":
        n_blocks = cfg.n_layers // len(cfg.block_pattern)
        for part, tree in blocks["rec"].items():
            for name, stacked in tree.items():
                _check_depth(f"blocks.rec.{part}.{name}", stacked, n_blocks)
                for i in range(n_blocks):
                    for r in range(2):
                        sd[f"layers.{3 * i + r}.{part}.{name}"] = tensor(stacked[i][r], part, name)
        for part, tree in blocks["attn"].items():
            for name, stacked in tree.items():
                _check_depth(f"blocks.attn.{part}.{name}", stacked, n_blocks)
                for i in range(n_blocks):
                    sd[f"layers.{3 * i + 2}.{part}.{name}"] = tensor(stacked[i], part, name)
        n_tail = len(cfg.tail_pattern)
        for part, tree in np_params["tail"].items():
            for name, stacked in tree.items():
                _check_depth(f"tail.{part}.{name}", stacked, n_tail)
                for t in range(n_tail):
                    sd[f"layers.{3 * n_blocks + t}.{part}.{name}"] = tensor(stacked[t], part, name)
        return sd
    if cfg.family == "vlm":
        k = cfg.cross_attn_every
        n_super, inner = cfg.n_layers // k, k - 1
        for part, tree in blocks["self"].items():
            for name, stacked in tree.items():
                _check_depth(f"blocks.self.{part}.{name}", stacked, n_super)
                for s in range(n_super):
                    _check_depth(f"blocks.self.{part}.{name}[{s}]", stacked[s], inner)
                    for r in range(inner):
                        sd[f"blocks.{k * s + r}.{part}.{name}"] = tensor(stacked[s][r], part, name)
        for part, tree in blocks["cross"].items():
            for name, stacked in tree.items():
                _check_depth(f"blocks.cross.{part}.{name}", stacked, n_super)
                for s in range(n_super):
                    sd[f"blocks.{k * s + inner}.{part}.{name}"] = tensor(stacked[s], part, name)
        return sd
    for part in ("attn", "mlp", "moe"):
        for name, stacked in blocks.get(part, {}).items():
            _check_depth(f"blocks.{part}.{name}", stacked, cfg.n_layers)
            for i in range(cfg.n_layers):
                sd[f"blocks.{i}.{part}.{name}"] = tensor(stacked[i], part, name)
    return sd


def jax_leaf_path(name: str, cfg: ArchConfig) -> tuple[str, ...]:
    """The key path of the reference's leaf that carries the port's parameter
    ``name`` (the inverse of :func:`params_from_jax`'s mapping, layer index
    dropped: the reference stacks layers along the leaf's leading axes)."""
    parts = name.split(".")
    if len(parts) == 1:
        return (name,)
    j, rest = int(parts[1]), tuple(parts[2:])
    if cfg.family == "ssm":
        return ("blocks", *rest)
    if cfg.family == "hybrid":
        n_blocks = cfg.n_layers // len(cfg.block_pattern)
        if j >= 3 * n_blocks:
            return ("tail", *rest)
        return ("blocks", "attn" if j % 3 == 2 else "rec", *rest)
    if cfg.family == "vlm":
        k = cfg.cross_attn_every
        return ("blocks", "cross" if j % k == k - 1 else "self", *rest)
    return ("blocks", *rest)


def jax_leaf_groups(cfg: ArchConfig, names) -> dict[tuple[str, ...], list[str]]:
    """The reference's leaves, each key path -> the port's parameters it
    carries, in its stacking order: ``torch.stack`` of the group, flattened,
    runs through the leaf's elements in the leaf's own flat order (the
    reference stacks layers in ascending layer index in every family)."""
    groups: dict[tuple[str, ...], list[str]] = {}
    for n in sorted(names, key=lambda n: int(n.split(".")[1]) if "." in n else -1):
        groups.setdefault(jax_leaf_path(n, cfg), []).append(n)
    return groups


def _check_depth(where: str, stacked, want: int) -> None:
    if len(stacked) != want:
        raise ValueError(f"{where}: {len(stacked)} layers, want {want}")


def dlrm_params_from_jax(np_params: dict, cfg) -> dict[str, torch.Tensor]:
    """A ``state_dict`` for the module ``models.dlrm.init`` builds from the
    reference's DLRM parameters (CPU tensors, fp32); ``cfg`` is a
    ``DLRMConfig``."""

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd = {"tables": tensor(np_params["tables"])}
    want = {"bottom": len(cfg.bottom_mlp) + 1, "top": len(cfg.top_mlp)}
    for name, n in want.items():
        _check_depth(name, np_params[name], n)
        for i, lyr in enumerate(np_params[name]):
            sd[f"{name}.{i}.w"] = tensor(lyr["w"])
            sd[f"{name}.{i}.b"] = tensor(lyr["b"])
    return sd
