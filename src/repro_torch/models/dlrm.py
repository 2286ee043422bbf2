"""DLRM (paper §2.1, List 1), the paper's flagship workload: the counterpart
of ``repro.models.dlrm``.

Embedding tables, bottom and top MLPs and a pairwise dot interaction, as in
facebookresearch/dlrm.  Every embedding lookup goes through
``ops.bag_lookup`` (the embedding-bag kernel on the card) with one id per
bag, which computes the reference's gather; the MLPs and the interaction
are plain matrix products (cuBLAS), as the reference leaves them to XLA.
``loss_fn`` trains as well as scores: under grad the lookup goes through
``kernels.embedding_bag.EmbeddingBagFn``, whose backward is the
deterministic embedding-bag backward kernel on the card (the plain version
on the CPU), with ``jax.grad``'s rule for ids outside the table.  The
training loop is ``repro_torch.launch.dlrm_testbed.train_dlrm``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..compat import resolve_device
from ..kernels import ops
from . import layers as L


@dataclass(frozen=True)
class DLRMConfig:
    n_tables: int = 8
    rows_per_table: int = 1000
    embed_dim: int = 32
    dense_features: int = 13
    bottom_mlp: tuple[int, ...] = (64, 32)
    top_mlp: tuple[int, ...] = (64, 1)


def paper_config(n_tables: int = 8) -> DLRMConfig:
    """The paper's DLRM (``repro.core.workloads.DLRM``: tables of 1e7 rows x
    128 dims, 8 dense layers of 2048, 16 feature layers of 4096) with
    ``n_tables`` of its 64 tables.  The dense layers are the bottom MLP, the
    feature layers the top MLP; 13 dense features, as Criteo has.  8 tables
    (40.96 GB in fp32) are one table host's share when the 64 are spread
    over 8 hosts."""
    return DLRMConfig(
        n_tables=n_tables, rows_per_table=10_000_000, embed_dim=128, dense_features=13,
        bottom_mlp=(2048,) * 8, top_mlp=(4096,) * 16 + (1,),
    )


class Dense(nn.Module):
    """One MLP layer: ``w`` (d_in, d_out) and ``b`` (d_out,), fp32."""

    def __init__(self, gen, d_in: int, d_out: int, device):
        super().__init__()
        self.w = L.parameter(L.dense_init(gen, d_in, d_out, torch.float32, device))
        self.b = L.parameter(torch.zeros(d_out, dtype=torch.float32, device=device))


def _mlp_init(gen, dims, device) -> nn.ModuleList:
    return nn.ModuleList(Dense(gen, dims[i], dims[i + 1], device) for i in range(len(dims) - 1))


class DLRM(nn.Module):
    """``init``'s parameters: ``tables`` (T, R, E) fp32, and ``bottom`` and
    ``top``, one ``Dense`` per layer."""

    def __init__(self, cfg: DLRMConfig, seed: int, device: torch.device):
        super().__init__()
        gen = torch.Generator(device=device).manual_seed(seed)
        T, R, E = cfg.n_tables, cfg.rows_per_table, cfg.embed_dim
        # The reference stacks per-table draws; here each table is drawn in
        # place into its slice, so the tables never exist twice.
        tables = torch.empty((T, R, E), dtype=torch.float32, device=device)
        for t in range(T):
            L.truncated_normal_(tables[t], gen, 1.0 / math.sqrt(E))
        self.tables = L.parameter(tables)
        self.bottom = _mlp_init(gen, (cfg.dense_features, *cfg.bottom_mlp, E), device)
        n_pairs = (T + 1) * T // 2
        self.top = _mlp_init(gen, (E + n_pairs, *cfg.top_mlp), device)


def init(seed: int, cfg: DLRMConfig, device: str | torch.device | None = None) -> DLRM:
    """Random parameters drawn directly on ``device`` (the card by default)."""
    return DLRM(cfg, seed, resolve_device(device))


def _mlp(layers, x):
    for i, lyr in enumerate(layers):
        x = x @ lyr.w + lyr.b
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def forward(params, dense, sparse_ids, cfg: DLRMConfig):
    """dense: (B, dense_features) fp32; sparse_ids: (B, n_tables) int32 or
    int64 -> logits (B,), no final sigmoid."""
    bot = _mlp(params.bottom, dense)  # (B, E)
    emb = ops.bag_lookup(params.tables, sparse_ids[:, :, None])  # (B, T, E)
    feats = torch.cat([bot[:, None, :], emb], dim=1)  # (B, T+1, E)
    inter = torch.bmm(feats, feats.transpose(1, 2))  # (B, T+1, T+1)
    n = cfg.n_tables + 1
    iu, ju = torch.triu_indices(n, n, offset=1, device=dense.device)
    top_in = torch.cat([bot, inter[:, iu, ju]], dim=1)  # (B, E + n_pairs)
    return _mlp(params.top, top_in)[:, 0]


def loss_fn(params, batch, cfg: DLRMConfig):
    """Binary cross-entropy on logits -> (loss, {"bce": loss})."""
    logits = forward(params, batch["dense"], batch["sparse"], cfg)
    y = batch["label"].float()
    loss = torch.mean(
        torch.clamp(logits, min=0) - logits * y + torch.log1p(torch.exp(-logits.abs()))
    )
    return loss, {"bce": loss}
