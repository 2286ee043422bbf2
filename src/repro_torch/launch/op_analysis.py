"""Per-device cost of an eager step, counted op by op (``repro.launch.hlo_analysis``'s
counterpart; the port has no HLO).

:class:`OpAnalysis` is a ``TorchDispatchMode``.  It returns ``NotImplemented``
for an op on DTensors, so DTensor runs the op as this rank's local ops, and
those come back through the mode with the shapes one rank holds: every
number is per device.  Its rules mirror ``analyze_hlo``'s:

* FLOPs only for products: ``mm``, ``bmm``, ``addmm`` and ``baddbmm`` (2 a
  multiply-add), and the kernel ops (``repro::*``) through the shape-only
  formulas of :mod:`repro_torch.launch.roofline`; the scans run no product,
  as XLA's scan has no ``dot``, and count 0;
* bytes as operands plus result of every op, except views and allocations
  (the counterpart of ``_SKIP_BYTES``), in-place updates of a buffer
  (``index_put_``, ``copy_`` into a slice, ``scatter``), which move twice
  the update, and a gather out of a buffer at least 4 times larger than
  what it reads and writes, which moves twice that;
* collective payloads by the reference's names and factors: all-reduce
  twice its payload, all-gather, reduce-scatter and all-to-all once their
  result, send and recv (collective-permute) once their payload.

An eager step dispatches every iteration of its loops, so nothing needs a
trip count.  The mode also tracks memory: each storage an op creates is
live until it is freed, and ``peak_bytes`` is the largest sum of live
bytes, on top of the storages that existed before (``hold``).
"""

from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from . import roofline

_COLLECTIVE_FACTORS = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}
# Allocations, host reads and the views that no schema marks as one: no
# memory traffic of their own.
_SKIP_BYTES = {
    "aten::_unsafe_view", "aten::empty", "aten::empty_like", "aten::empty_strided", "aten::new_empty",
    "aten::new_empty_strided", "aten::_local_scalar_dense", "aten::resize_", "aten::set_",
    "_c10d_functional::wait_tensor", "_c10d_functional::_wrap_tensor_autograd",
}
_UPDATE_OPS = {
    "aten::index_put", "aten::index_put_", "aten::_index_put_impl_", "aten::copy_",
    "aten::scatter", "aten::scatter_", "aten::scatter_add", "aten::scatter_add_",
    "aten::scatter_reduce", "aten::scatter_reduce_", "aten::index_add", "aten::index_add_",
    "aten::index_copy", "aten::index_copy_", "aten::slice_scatter", "aten::select_scatter",
}
_SLICE_OPS = {"aten::index", "aten::gather", "aten::index_select", "aten::embedding"}


def collective_type(name: str) -> str | None:
    """The reference's collective type of a c10d op (``c10d::allreduce_``,
    ``_c10d_functional::all_gather_into_tensor``, ...); None for any other op."""
    ns, _, op = name.partition("::")
    if ns not in ("c10d", "_c10d_functional"):
        return None
    op = op.lstrip("_").replace("_", "")
    for prefix, kind in (("allreduce", "all-reduce"), ("allgather", "all-gather"),
                         ("reducescatter", "reduce-scatter"), ("alltoall", "all-to-all"),
                         ("send", "collective-permute"), ("recv", "collective-permute")):
        if op.startswith(prefix):
            return kind
    return None


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


def _bound(func, args, kwargs) -> dict:
    """The op's arguments by their schema names."""
    named = {a.name: v for a, v in zip(func._schema.arguments, args)}
    named.update(kwargs)
    return named


def product_flops(name: str, a: dict) -> float:
    """The product FLOPs of one op from its named arguments (0 for an op
    that runs no product)."""
    if name in ("aten::mm", "aten::addmm"):
        m1, m2 = (a["self"], a["mat2"]) if name == "aten::mm" else (a["mat1"], a["mat2"])
        return 2.0 * m1.shape[0] * m1.shape[1] * m2.shape[1]
    if name in ("aten::bmm", "aten::baddbmm"):
        b1, b2 = (a["self"], a["mat2"]) if name == "aten::bmm" else (a["batch1"], a["batch2"])
        return 2.0 * b1.shape[0] * b1.shape[1] * b1.shape[2] * b2.shape[2]
    if name in ("repro::flash_attention", "repro::flash_attention_bwd"):
        B, H, Sq, D = a["q"].shape
        return roofline.attention_flops(B, H, D, Sq, a["k"].shape[2], a["causal"],
                                        a["window"], backward=name.endswith("_bwd"))
    if name in ("repro::moe_gmm", "repro::moe_gmm_bwd"):
        E, C, D = a["x"].shape
        products = int(a["need_dx"]) + int(a["need_dw"]) if name.endswith("_bwd") else 1
        return roofline.grouped_matmul_flops(E, C, D, a["w"].shape[2], products)
    return 0.0


def op_bytes(name: str, operands: list[torch.Tensor], results: list[torch.Tensor]) -> float:
    """The memory traffic of one op (``analyze_hlo``'s fusion-boundary rule)."""
    res_b = _nbytes(results)
    sizes = [_nbytes([t]) for t in operands]
    big = max(sizes, default=0.0)
    others = sum(sizes) - big
    if name in _UPDATE_OPS and big >= res_b * 0.99:
        return 2.0 * others  # the update read, the updated region written
    if name in _SLICE_OPS and big >= 4 * max(res_b + others, 1.0):
        return 2.0 * (res_b + others)  # a small read out of a big buffer
    return res_b + sum(sizes)


class OpAnalysis(TorchDispatchMode):
    """Counts the ops dispatched while it is active; read :meth:`result`."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: dict[str, float] = defaultdict(float)
        self._held: set[int] = set()  # storages held before the step
        self._live: dict[int, int] = {}  # storages made since, by their bytes
        self._live_bytes = 0
        self.held_bytes = 0.0
        self.peak_temp_bytes = 0.0

    def hold(self, tree) -> None:
        """Takes the storages of ``tree``'s tensors (DTensors: their local
        shards) as held before the step: their bytes count in the peak
        once, and an op's views of them allocate nothing."""
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            if st._cdata not in self._held:
                self._held.add(st._cdata)
                self.held_bytes += st.nbytes()

    def made_bytes(self, tree) -> float:
        """The bytes of the storages of ``tree``'s tensors that the step made
        and that are still live (its outputs)."""
        keys = {_local(t).untyped_storage()._cdata for t in _tensors(tree)}
        return float(sum(self._live.get(k, 0) for k in keys))

    def _track(self, results: list[torch.Tensor]) -> None:
        for t in results:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held or key in self._live:
                continue
            self._live[key] = st.nbytes()
            self._live_bytes += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak_temp_bytes = max(self.peak_temp_bytes, float(self._live_bytes))

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        results = _tensors(out)
        kind = collective_type(name)
        if kind is not None:
            # Ops that write into their first argument return only a Work.
            payload = _nbytes(results or _tensors(args[:1]))
            self.coll[kind] += _COLLECTIVE_FACTORS[kind] * payload
        self.flops += product_flops(name, _bound(func, args, kwargs))
        if not (func.is_view or name in _SKIP_BYTES):
            self.bytes += op_bytes(name, _tensors((args, kwargs)), results)
        self._track(results)
        return out

    def result(self) -> dict:
        """``analyze_hlo``'s keys (per device), and the memory the step held:
        ``argument_bytes`` (held before it), ``peak_temp_bytes`` (the most
        its own storages held at once) and ``peak_bytes``, their sum."""
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": float(sum(self.coll.values())),
            "collectives_by_type": {k: float(v) for k, v in self.coll.items()},
            "argument_bytes": self.held_bytes,
            "peak_temp_bytes": self.peak_temp_bytes,
            "peak_bytes": self.held_bytes + self.peak_temp_bytes,
        }


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t
