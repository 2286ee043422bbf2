"""Model implementation options (the §Perf hillclimbing levers).

Set process-globally before a model runs.  The fields and defaults are the
reference's (``repro.parallel.options``).  In the port both attention impls
run the hand-written flash-attention kernel on the card: the kernel already
is the chunked online-softmax path.  ``moe_constrain`` and
``moe_gather_constrain`` are read by no model: in the reference they add
GSPMD hints on the MoE's dispatch buffers, and the port's MoE layer writes
its expert-parallel dispatch out (``models.layers.moe``) whatever they say.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelOptions:
    # "naive": materialize (S, T) scores.  "chunked": flash-style online
    # softmax over KV chunks.  Prefill attention takes the kernel for both.
    attention_impl: str = "naive"
    attention_chunk: int = 1024
    # "assoc": associative-scan tree (materializes (B, L, D, ST) per chunk).
    # "assoc_ckpt": recompute the tree in bwd.  "seq": sequential scan.
    scan_impl: str = "assoc"
    scan_chunk: int = 256
    # constrain MoE dispatch buffers to expert-parallel sharding
    moe_constrain: bool = False
    # constrain MoE token gathers to batch sharding
    moe_gather_constrain: bool = False
    # norm statistics in fp32 but elementwise scaling in the activation
    # dtype (halves residual-stream HBM traffic; MaxText-style)
    lowp_norm: bool = False


_OPTS = ModelOptions()


def set_options(opts: ModelOptions | None) -> None:
    global _OPTS
    _OPTS = opts or ModelOptions()


def get_options() -> ModelOptions:
    return _OPTS


def with_options(**kw) -> ModelOptions:
    return replace(ModelOptions(), **kw)
