"""Cost analysis of the operations a step dispatches.

Counterpart of ``repro.core.hlo_analysis``. The reference compiles a
step and re-derives its costs from the post-SPMD HLO text, multiplying
each ``while`` body by its trip count. The port runs the step once,
eagerly (on the ``meta`` device for the dry run), under a
``TorchDispatchMode`` that sees every operation as it is dispatched.
Python loops run each iteration, so nothing is counted once for many.
Under DTensor the mode lets DTensor go first (it returns
``NotImplemented`` for a DTensor operation), so it counts rank 0's own
program: the local shards, and the collectives DTensor inserts to move
between placements. It counts

* dot FLOPs, by ``torch.utils.flop_counter``'s formula for each matmul,
  batched matmul, convolution and attention op it knows, plus what each
  hand-written kernel's ``meta`` branch reports through :func:`record`
  (one formula per kernel, :mod:`repro_torch.kernels.cost`);
* dot bytes: the operands and output of those ops and kernels;
* collective bytes by kind: the output bytes of each ``_c10d_functional``
  or ``c10d`` collective, the reference's proxy for the bytes moved;
* parameter bytes: every tensor argument of the step (weights, optimizer
  state, inputs, cache), as the reference counts the entry parameters;
* the peak of live intermediate bytes: each new storage an operation
  creates is added when it is created and taken off when it is freed.

Elementwise traffic is left out of the bytes, as in the reference. All
counts are per device; callers multiply by the chip count.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# collective op name (either namespace) -> kind
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "c10d_functional")


@dataclasses.dataclass
class OpCost:
    """``HloCost``'s fields, plus the peak of live intermediates and the
    hand-written kernels' calls by name."""
    dot_flops: float = 0.0
    dot_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_breakdown: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    parameter_bytes: float = 0.0
    peak_bytes: float = 0.0
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s own elements; of its local shard for a DTensor."""
    local = getattr(t, "_local_tensor", t)
    return local.numel() * local.element_size()


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor leaf of ``tree`` (dicts, lists, tuples,
    NamedTuples), local shards for DTensors."""
    return sum(tensor_bytes(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


_ACTIVE: List["OpCounter"] = []


def record(name: str, flops: float, nbytes: float) -> None:
    """A hand-written kernel's ``meta`` branch reports one call: its
    FLOPs and the bytes it moves, to every active counter."""
    for c in _ACTIVE:
        c.cost.dot_flops += flops
        c.cost.dot_bytes += nbytes
        c.cost.kernels[name] = c.cost.kernels.get(name, 0) + 1


def counting() -> bool:
    """Whether a cost analysis is running: the kernels' ``meta`` branches
    report to it, and without one a meta tensor has no kernel."""
    return bool(_ACTIVE)


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


class OpCounter(TorchDispatchMode):
    """Counts what runs under it into ``self.cost`` (:class:`OpCost`).
    Operations on fake tensors (DTensor's shape propagation) are run and
    not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.cost = OpCost()
        self._live: Dict[int, List[int]] = {}     # storage -> [bytes, refs]
        self._now = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flat_in = [a for a in tree_leaves((args, kwargs))
                   if isinstance(a, torch.Tensor)]
        flat_out = [t for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
        if any(_is_fake(a) for a in flat_in + flat_out):
            return out
        packet = func._overloadpacket
        ns = packet._qualified_op_name.split("::")[0]
        if packet in self._flops:
            self.cost.dot_flops += self._flops[packet](*args, **kwargs,
                                                       out_val=out)
            self.cost.dot_bytes += sum(tensor_bytes(t)
                                       for t in flat_in + flat_out)
        elif ns in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVE_OPS.get(packet.__name__)
            if kind is not None:
                b = sum(tensor_bytes(t) for t in flat_out)
                self.cost.collective_bytes += b
                self.cost.collective_breakdown[kind] += b
        self._track(flat_out, flat_in)
        return out

    def _track(self, outs, ins) -> None:
        """Add each output storage that no input shares and no earlier
        output made; take it off when its last tensor is freed."""
        known = {self._sid(t) for t in ins}
        for t in outs:
            sid = self._sid(t)
            if sid in known and sid not in self._live:
                continue                      # a view of an argument
            entry = self._live.get(sid)
            if entry is None:
                nbytes = t.untyped_storage().nbytes()
                entry = self._live[sid] = [nbytes, 0]
                self._now += nbytes
                self.cost.peak_bytes = max(self.cost.peak_bytes, self._now)
            entry[1] += 1
            weakref.finalize(t, self._release, sid)

    def _release(self, sid: int) -> None:
        entry = self._live.get(sid)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self._now -= entry[0]
            del self._live[sid]

    @staticmethod
    def _sid(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata


def analyze_step(fn: Callable, *args, **kwargs) -> Tuple[Any, OpCost]:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpCounter`.
    Returns (its output, the per-device :class:`OpCost`), with
    ``parameter_bytes`` the local bytes of every tensor argument."""
    counter = OpCounter()
    with counter:
        out = fn(*args, **kwargs)
    counter.cost.parameter_bytes = float(tree_bytes((args, kwargs)))
    return out, counter.cost
