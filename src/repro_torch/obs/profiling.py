"""Profiler annotations around the kernel call sites.

:func:`annotate` wraps a kernel wrapper's body in
``torch.profiler.record_function(name)`` when profiling is enabled, so a
``torch.profiler`` trace lines up with the serving tier's span names and
the reference's (``sandwich_matmul``, ``butterfly_matmul``,
``paged_attention``, ``flash_attention``). Enablement comes from the
resolution order the kernels use everywhere else:

* an explicit :class:`~repro_torch.kernels.context.ExecutionContext`
  passed by the call site (the kernel wrappers pass their resolved one),
* else the ambient ``use_execution(...)`` context of this thread,
* else the ``REPRO_PROFILE`` environment variable (``1``, ``true`` or
  ``on``).

A context's ``profile=None`` is unset and falls through. When profiling is
off — the default — :func:`annotate` returns one shared
``contextlib.nullcontext``, so an eager call pays an attribute check and
one environment read.

CUDA graphs: the engine's ticks are captured once per key and replayed.
The annotation runs in Python, so it exists only while a graph is
captured (the key's first tick); a profiled replay shows the graph's
kernels without these ranges.
"""

from __future__ import annotations

import contextlib
import os
from typing import ContextManager, Optional

from repro_torch.kernels.context import ExecutionContext, current_execution

__all__ = ["annotate", "profiling_enabled"]

_NULL = contextlib.nullcontext()


def profiling_enabled(ctx: Optional[ExecutionContext] = None) -> bool:
    """True when kernel call sites should emit profiler annotations."""
    if ctx is None:
        ctx = current_execution()
    if ctx is not None and ctx.profile is not None:
        return bool(ctx.profile)
    return os.environ.get("REPRO_PROFILE", "").strip() in ("1", "true", "on")


def annotate(name: str, ctx: Optional[ExecutionContext] = None
             ) -> ContextManager:
    """``torch.profiler.record_function(name)`` if profiling, else a
    no-op."""
    if not profiling_enabled(ctx):
        return _NULL
    import torch.profiler
    return torch.profiler.record_function(name)
