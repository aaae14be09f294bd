"""Profiler annotations around the kernel call sites.

:func:`annotate` wraps a kernel wrapper's body in
``torch.profiler.record_function(name)`` when profiling is enabled, so a
``torch.profiler`` trace lines up with the serving tier's span names and
the reference's (``sandwich_matmul``, ``butterfly_matmul``,
``paged_attention``, ``flash_attention``). Enablement, in order:

* the explicit ``enabled`` argument of the call,
* else the ``REPRO_PROFILE`` environment variable (``1``, ``true`` or
  ``on``).

The reference also reads the ambient ``ExecutionContext.profile`` between
the two; the port has no ``ExecutionContext`` yet.

When profiling is off — the default — :func:`annotate` returns one shared
``contextlib.nullcontext``, so an eager call pays one environment read.

CUDA graphs: the engine's ticks are captured once per key and replayed.
The annotation runs in Python, so it exists only while a graph is
captured (the key's first tick); a profiled replay shows the graph's
kernels without these ranges.
"""

from __future__ import annotations

import contextlib
import os
from typing import ContextManager, Optional

__all__ = ["annotate", "profiling_enabled"]

_NULL = contextlib.nullcontext()


def profiling_enabled(enabled: Optional[bool] = None) -> bool:
    """True when kernel call sites should emit profiler annotations."""
    if enabled is not None:
        return bool(enabled)
    return os.environ.get("REPRO_PROFILE", "").strip() in ("1", "true", "on")


def annotate(name: str, enabled: Optional[bool] = None) -> ContextManager:
    """``torch.profiler.record_function(name)`` if profiling, else a
    no-op."""
    if not profiling_enabled(enabled):
        return _NULL
    import torch.profiler
    return torch.profiler.record_function(name)
