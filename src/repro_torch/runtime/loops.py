"""Sequential loops over time that an op tally counts once.

The sLSTM's scan, the mLSTM's recurrent form and its chunk loop run one
step per token (or chunk) from the host, as the reference's ``lax.scan``\\ s
run one step per iteration; the blockwise attention loops over key blocks
and the layer stack over its unit's repeats. The op tally of the dry-run
(:mod:`repro_torch.launch.op_analysis`) counts one step and multiplies it
by the number of steps, as the reference's HLO analysis multiplies a loop
body by its trip count; at 32k or 512k positions an unrolled tally could
not finish. These hooks are the loops' side of that: outside a tally they
are ``range`` and ``torch.stack``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator, List, Optional

import torch

_LOCAL = threading.local()


def _hook() -> Optional[Callable[[int], contextlib.AbstractContextManager]]:
    return getattr(_LOCAL, "hook", None)


@contextlib.contextmanager
def counted_once(hook: Callable[[int], contextlib.AbstractContextManager]):
    """Within the block, :func:`steps` runs one step under ``hook(n)`` (a
    context that multiplies what is counted inside by ``n``) and
    :func:`stack` widens that step's output to ``n``."""
    prev = _hook()
    _LOCAL.hook = hook
    try:
        yield
    finally:
        _LOCAL.hook = prev


def steps(n: int) -> Iterator[int]:
    """The indices of a sequential loop of ``n`` steps: ``range(n)``, or
    under :func:`counted_once` step 0 and then step 1 counted ``n - 1``
    times (the first step differs from the others: its state comes fresh,
    and its backward stops there)."""
    hook = _hook()
    if hook is None or n <= 2:
        yield from range(n)
        return
    yield 0
    with hook(n - 1):
        yield 1


def layers(n_layers: int, unit: int, repeats: int) -> Iterator[int]:
    """The indices of a layer stack of ``repeats`` repeats of a ``unit`` of
    layers and a tail: ``range(n_layers)``, or under :func:`counted_once`
    the first repeat's layers, counted ``repeats`` times, then the tail."""
    hook = _hook()
    if hook is None or repeats <= 1:
        yield from range(n_layers)
        return
    with hook(repeats):
        yield from range(unit)
    yield from range(unit * repeats, n_layers)


def stack(items: List[torch.Tensor], n: int, dim: int) -> torch.Tensor:
    """``torch.stack(items, dim)`` of a loop's ``n`` per-step outputs; under
    :func:`counted_once` the :func:`steps` run's two outputs, stacked and
    widened to the stacked shape, their copy (and its backward) counted as
    ``n`` outputs' and the widening not at all (the values do not matter
    there: the tally runs on meta tensors)."""
    hook = _hook()
    if hook is None or len(items) == n:
        return torch.stack(items, dim=dim)
    with hook(n / len(items)):
        one = torch.stack(items, dim=dim)
    rest = list(one.shape)
    rest[dim] = n - one.shape[dim]
    with hook(0):               # widened for the shapes, counted as nothing
        fill = one.narrow(dim, 0, 1).expand(rest)
        return torch.cat([one, fill], dim=dim)
