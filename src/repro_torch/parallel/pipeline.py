"""Pipeline parallelism: a GPipe microbatch schedule over a ``pipe`` mesh
axis with point-to-point stage handoffs (``repro.parallel.pipeline``'s
counterpart).

Stages hold disjoint layer slices (the parameters stacked stage-major on a
leading axis).  The schedule runs ``n_micro + n_stages - 1`` ticks; at each
tick every stage applies its layers to its current activation, bubbles
included, and hands the result to the next stage.  Bubble fraction =
(S-1)/(M+S-1), the classic GPipe trade-off; the pipeline's point-to-point
edges are the MP transfers TopologyFinder's Blossom matching serves with
direct links.
"""

from __future__ import annotations

import torch

from ..core.collectives import ppermute, psum
from ..core.device_order import MeshAxis


def gpipe_forward(stage_fn, stage_params, microbatches: torch.Tensor,
                  axis: MeshAxis) -> torch.Tensor:
    """Runs microbatches through the pipeline.

    stage_fn: (stage_params, x) -> y, applied by every stage (params differ).
    stage_params: this stage's parameters.
    microbatches: (M, mb, ...); every stage holds them, stage 0 consumes them.
    Returns (M, mb, ...) outputs, valid on the LAST stage (zeros elsewhere).
    """
    S, sid = axis.size, axis.index
    M = microbatches.shape[0]
    fwd_perm = [(i, i + 1) for i in range(S - 1)]
    carry = torch.zeros_like(microbatches[0])  # stage 0 receives nothing
    outs = torch.zeros_like(microbatches)
    for t in range(M + S - 1):
        x = microbatches[min(t, M - 1)] if sid == 0 else carry
        y = stage_fn(stage_params, x)
        # The last stage's result is microbatch t - S + 1.
        idx = t - S + 1
        if sid == S - 1 and 0 <= idx < M:
            outs[idx] = y
        carry = ppermute(y, axis, fwd_perm)  # the last stage sends nowhere
    return outs


def _stage(tree, i: int):
    if isinstance(tree, dict):
        return {k: _stage(v, i) for k, v in tree.items()}
    return tree[i]


def make_gpipe_step(stage_fn, mesh, axis_name: str = "pipe"):
    """-> ``run(params_stacked, microbatches)``: each rank takes its stage's
    slice of the stage-major parameters (a tensor or a dict of them), runs
    :func:`gpipe_forward`, and sums the outputs over the axis, which
    broadcasts the last stage's."""
    axis = mesh.axis(axis_name)

    def run(params_stacked, microbatches):
        outs = gpipe_forward(stage_fn, _stage(params_stacked, axis.index), microbatches, axis)
        return psum(outs, axis)

    return run
