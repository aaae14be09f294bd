"""An op-level cost tally over meta tensors: the counterpart of
``repro.launch.hlo_analysis``.

The reference reads FLOPs and HBM bytes from a compiled executable's HLO
text, multiplying each while-loop body by its trip count. The port has no
compiled artifact to read; :class:`OpTally` is a ``TorchDispatchMode``
that sees every aten op a step dispatches — on ``meta`` tensors, so
nothing is allocated and nothing launches — and accumulates:

* FLOPs — matmul-family ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolutions, SDPA) as ``torch.utils.flop_counter`` counts them;
  pointwise and reduction ops at one FLOP per output element, as the
  reference counts its elementwise and reduce ops;
* bytes — per op, the bytes of its tensor inputs read plus its outputs
  written (views and allocations move nothing). Every op counts, where
  XLA's fusions would keep intermediates on chip: an upper estimate of an
  eager step's traffic;
* the counts, FLOPs and bytes by op kind;
* of those bytes, a group's (``bytes_by_group``): the reads and writes
  of the tensors given to :meth:`OpTally.mark` under that group (a
  model's ``"weights"``, its ``"caches"``) and of the tensors computed
  from that group's alone (a view, a cast); and as ``"state"`` every
  byte counted inside :meth:`OpTally.state` (the optimizer's update). A
  mesh's dry-run spreads each group by its own sharding
  (:mod:`repro_torch.launch.dryrun`).

Loops are counted once and multiplied. Inside :meth:`OpTally.repeat`
every count is multiplied by ``n``; with ``loops=True`` the tally installs
:func:`repro_torch.runtime.loops.counted_once`, so the model's sequential
loops (the sLSTM's scan, the mLSTM's recurrent form and chunk loop, the
blockwise attention's key blocks) run their first step and one more,
counted for all the others, and the layer stack runs one repeat of its
unit, counted for every repeat (:func:`repro_torch.runtime.loops.steps`,
:func:`~repro_torch.runtime.loops.layers`). An unrolled tally
(``loops=False``) of the same call gives the same FLOPs and bytes (tested;
in training, up to the gradient sums of a tensor every repeat reads, such
as an ``xdec`` stack's encoder output); the multiplied one is what makes
32k- and 512k-position cells countable. The backward runs after the forward's loops have returned, so
its ops are multiplied by the scope their forward op ran in: each
:meth:`OpTally.repeat` records the autograd sequence numbers of the nodes
created inside it, and a backward op takes the multiplier of the node
autograd is running (``torch._C._current_autograd_node``). A checkpointed
layer's recompute runs inside its backward and takes both its node's
multiplier and that of the loops it runs again.
"""

from __future__ import annotations

import contextlib
import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.runtime import loops

#: reductions (one FLOP per output element) the pointwise tag misses
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "cumsum", "cumprod", "_softmax", "_log_softmax", "var", "std",
    "var_mean", "norm", "linalg_vector_norm", "argmax", "argmin", "any",
    "all", "_softmax_backward_data", "_log_softmax_backward_data",
}
#: ops that allocate or reinterpret without moving data
_FREE = {
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_to_copy_meta", "lift_fresh", "detach", "alias",
    "_unsafe_view", "view", "expand", "permute", "transpose", "t",
    "unsqueeze", "squeeze", "select", "slice", "as_strided", "split",
    "split_with_sizes", "unbind", "chunk", "narrow", "diagonal", "unfold",
    "_reshape_alias", "view_as_real", "view_as_complex", "set_",
    "resize_", "is_same_size", "sym_size", "sym_stride", "sym_numel",
}


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor addresses (a broadcast,
    stride-0 dim counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


@dataclass
class OpTally:
    """FLOPs, bytes and op counts of what runs inside ``with tally:``."""

    loops: bool = True
    flops: float = 0.0
    matmul_flops: float = 0.0
    bytes: float = 0.0
    counts: Counter = field(default_factory=Counter)
    flops_by_kind: Counter = field(default_factory=Counter)
    bytes_by_kind: Counter = field(default_factory=Counter)
    bytes_by_group: Counter = field(default_factory=Counter)
    _mult: float = 1.0
    _in_state: bool = False
    # id -> (weakref, group) of every marked tensor and tensor computed
    # from one group's alone (an id alone could be reused by a later one)
    _marks: Dict[int, Tuple[weakref.ref, str]] = field(default_factory=dict)
    # (first, last + 1) autograd sequence numbers of the nodes created in a
    # repeat(n) block, and n
    _scopes: List[Tuple[int, int, float]] = field(default_factory=list)
    _memo: Dict[int, float] = field(default_factory=dict)
    _last_seq: int = 0

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Counts inside the block are multiplied by ``n``, and so are those
        of the backward of what it computes."""
        prev = self._mult
        self._mult = prev * n
        first = torch.autograd._get_sequence_nr()
        try:
            yield
        finally:
            self._mult = prev
            last = torch.autograd._get_sequence_nr()
            if last > first:
                self._scopes.append((first, last, n))
                self._memo.clear()

    def mark(self, tensors: Iterable[torch.Tensor], group: str) -> None:
        """Count the bytes of ``tensors``, and of what is computed from
        them alone, as ``group``'s."""
        for t in tensors:
            self._marks[id(t)] = (weakref.ref(t), group)

    def group_of(self, t: torch.Tensor) -> Optional[str]:
        ref, group = self._marks.get(id(t), (None, None))
        return group if ref is not None and ref() is t else None

    @contextlib.contextmanager
    def state(self):
        """Every byte counted inside the block is the optimizer state's
        (the update of the weights, their gradients and moments)."""
        prev, self._in_state = self._in_state, True
        try:
            yield
        finally:
            self._in_state = prev

    def _node_factor(self, node) -> float:
        """The product of the repeat blocks the forward op of ``node`` ran
        in (1 outside any)."""
        seq = node._sequence_nr()
        m = self._memo.get(seq)
        if m is None:
            m = 1.0
            for first, last, n in self._scopes:
                if first <= seq < last:
                    m *= n
            self._memo[seq] = m
        return m

    def multiplier(self) -> float:
        """What an op dispatched now counts for: the open repeat blocks'
        product, times, in a backward, that of the blocks the running
        node's forward op ran in."""
        node = torch._C._current_autograd_node()
        if node is None:
            return self._mult
        return self._mult * self._node_factor(node)

    def _enter_op(self) -> None:
        """Nodes created inside a backward (a plain twin's own autograd,
        a checkpoint's recompute) since the last op take the running
        node's factor, so their backward counts as theirs does."""
        seq = torch.autograd._get_sequence_nr()
        node = torch._C._current_autograd_node()
        if node is not None and seq > self._last_seq:
            f = self._node_factor(node)
            if f != 1.0:
                self._scopes.append((self._last_seq, seq, f))
                self._memo.clear()
        self._last_seq = seq

    def _exit_op(self) -> None:
        self._last_seq = torch.autograd._get_sequence_nr()

    def __enter__(self) -> "OpTally":
        self._last_seq = torch.autograd._get_sequence_nr()
        self._mode = _TallyMode(self)
        self._stack = contextlib.ExitStack()
        if self.loops:
            self._stack.enter_context(loops.counted_once(self.repeat))
        self._stack.enter_context(self._mode)
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False

    def add(self, kind: str, flops: float, nbytes: float,
            matmul: bool, groups: Optional[Counter] = None) -> None:
        """Count one op: ``nbytes`` moved, ``groups`` of them by group."""
        m = self.multiplier()
        self.counts[kind] += m
        if flops:
            self.flops += m * flops
            self.flops_by_kind[kind] += m * flops
            if matmul:
                self.matmul_flops += m * flops
        if nbytes:
            self.bytes += m * nbytes
            self.bytes_by_kind[kind] += m * nbytes
            if self._in_state:
                self.bytes_by_group["state"] += m * nbytes
            else:
                for g, b in (groups or {}).items():
                    self.bytes_by_group[g] += m * b

    def to_dict(self) -> Dict:
        top = dict(sorted(self.flops_by_kind.items(),
                          key=lambda kv: -kv[1])[:12])
        return {"flops": self.flops, "matmul_flops": self.matmul_flops,
                "bytes": self.bytes,
                "bytes_by_group": dict(self.bytes_by_group),
                "ops": sum(self.counts.values()),
                "flops_by_kind": top}


class _TallyMode(TorchDispatchMode):
    def __init__(self, tally: OpTally):
        super().__init__()
        self.tally = tally

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tally = self.tally
        tally._enter_op()
        out = func(*args, **kwargs)
        tally._exit_op()
        ins, seen = [], set()
        for t in list(_tensors(args)) + list(_tensors(kwargs)):
            if id(t) not in seen:
                seen.add(id(t))
                ins.append(t)
        groups = [tally.group_of(t) for t in ins]
        common = groups[0] if ins and len(set(groups)) == 1 else None
        if common is not None:
            tally.mark(_tensors(out), common)
        packet = func._overloadpacket
        kind = packet.__name__
        if kind in _FREE or func.is_view:
            tally.counts[kind] += tally.multiplier()
            return out
        flops, matmul = 0, False
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            matmul = True
        elif torch.Tag.pointwise in func.tags or kind.rstrip("_") in \
                _REDUCTIONS:
            flops = sum(t.numel() for t in _tensors(out))
        if kind in ("copy_", "_to_copy", "clone", "contiguous"):
            flops = 0                      # data movement, no arithmetic
        nbytes, by_group = 0, Counter()
        for t, g in zip(ins, groups):
            nbytes += _nbytes(t)
            if g is not None:
                by_group[g] += _nbytes(t)
        for t in _tensors(out):
            nbytes += _nbytes(t)
            g = tally.group_of(t)
            if g is not None:
                by_group[g] += _nbytes(t)
        tally.add(kind, flops, nbytes, matmul, by_group)
        return out
