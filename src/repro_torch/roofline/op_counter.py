"""Operation counts of a torch step: the port's counterpart of the
reference's ``compiled.cost_analysis()`` plus ``hlo_analyzer.analyze``.

``OpCounter`` is a ``TorchDispatchMode``: run a step under it, typically on
the ``meta`` device where nothing is computed or allocated, and every aten
op it dispatches (forward, autograd's backward, a remat's recompute) adds
  flops : the matmul / bmm / convolution / attention FLOPs of
          ``torch.utils.flop_counter``'s formulas (2 * output * contraction,
          the ops ``hlo_analyzer.dot_flops`` counts);
  bytes : the op's tensor inputs plus outputs.  Views move nothing and
          count 0.  Eager PyTorch fuses nothing, so this is an upper bound
          on the traffic beside XLA's fused count (``hlo_analyzer`` counts
          only a fusion's operands and results).

Loops are counted as ``hlo_analyzer`` counts a ``while``: one trip times
the trip count.  With ``shortcut=True`` the counter binds itself to the
models' ``loops.trip_loop`` (in its own context only), which then runs
three trips: the first and the last as themselves (a recurrence's first
step starts from a state that needs no gradient, its last feeds no next
step; a ragged tail chunk is the last) and a middle one whose ops count
n - 2 times, including their backward: autograd nodes made during that
trip are tagged by sequence number, and an op that autograd's engine runs
for a tagged node counts n - 2 times as well, so do the gradient sums it
adds (a weight's grad over the steps).  FLOPs come out as the full loop's,
bytes within a few percent (the sums of per-step outputs, which the loop's
caller sees once per distinct trip).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.models import loops

#: ops that allocate without writing (their consumers' bytes count)
_NO_TRAFFIC = {"aten::empty", "aten::empty_strided", "aten::empty_like", "aten::detach",
               "aten::_unsafe_view", "aten::lift_fresh"}

@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0
    ops: float = 0.0

    def __add__(self, other: "OpCost") -> "OpCost":
        return OpCost(self.flops + other.flops, self.bytes + other.bytes, self.ops + other.ops)

    def __sub__(self, other: "OpCost") -> "OpCost":
        return OpCost(self.flops - other.flops, self.bytes - other.bytes, self.ops - other.ops)

    def __mul__(self, k: float) -> "OpCost":
        return OpCost(self.flops * k, self.bytes * k, self.ops * k)

    __rmul__ = __mul__


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class OpCounter(TorchDispatchMode):
    def __init__(self, shortcut: bool = True):
        super().__init__()
        self.shortcut = shortcut
        self.cost = OpCost()
        self._scopes: list[int] = []            # trip counts of the open trip_loops
        self._tagged: list[tuple[int, int, int]] = []   # (first seq, end seq, trips)
        self._paused = False

    def __enter__(self):
        self._binding = (loops.trip_counter(self) if self.shortcut
                         else contextlib.nullcontext())
        self._binding.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._binding.__exit__(None, None, None)

    def _seq(self) -> int:
        """The sequence number the next autograd node will get."""
        self._paused = True
        try:
            leaf = torch.empty((), device="meta", requires_grad=True)
            return leaf.view(()).grad_fn._sequence_nr() + 1
        finally:
            self._paused = False

    def _scale(self) -> float:
        k = 1.0
        for n in self._scopes:
            k *= n
        node = torch._C._current_autograd_node()
        if node is not None and self._tagged:
            seq = node._sequence_nr()
            for first, end, n in self._tagged:
                if first <= seq < end:
                    k *= n
                    break
        return k

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        k = self._scale()
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        if formula is not None:
            self.cost.flops += k * formula(*args, **kwargs, out_val=out)
        if not (func.is_view or func._schema.name in _NO_TRAFFIC):
            self.cost.bytes += k * (_bytes((args, kwargs)) + _bytes(out))
        self.cost.ops += k
        return out

    def trips(self, n: int):
        """``loops.trip_loop``'s trips under this counter: 0, 1 (counting
        n - 2 times) and n - 1."""
        if n <= 3:
            yield from range(n)
            return
        yield 0
        self._scopes.append(n - 2)
        first = self._seq() if torch.is_grad_enabled() else None
        try:
            yield 1
        finally:
            self._scopes.pop()
            if first is not None:
                self._tagged.append((first, self._seq(), n - 2))
        yield n - 1


def count(fn, *args, shortcut: bool = True, **kwargs) -> tuple[OpCost, object]:
    """(cost, result) of ``fn(*args, **kwargs)``."""
    with OpCounter(shortcut) as counter:
        out = fn(*args, **kwargs)
    return counter.cost, out
