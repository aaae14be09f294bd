"""Hand-written CUDA kernels of the port, each beside its plain twin, and
the execution-policy object their entry points dispatch on
(:mod:`repro_torch.kernels.context`)."""

from repro_torch.kernels.context import (Backend, ExecutionContext,
                                         clear_backend_cache,
                                         current_execution, resolve_backend,
                                         resolve_execution, use_execution)

__all__ = ["Backend", "ExecutionContext", "clear_backend_cache",
           "current_execution", "resolve_backend", "resolve_execution",
           "use_execution"]
