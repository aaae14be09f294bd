"""One object for every kernel-execution knob: :class:`ExecutionContext`.

Counterpart of ``repro.kernels.context``, in the port's backend names. The
resolution order is the reference's:

    explicit ``context=`` arg
      > ambient ``with use_execution(ctx):``
        > layer/config default (``ButterflyConfig`` via
          :meth:`ExecutionContext.from_butterfly_config`)
          > ``REPRO_KERNEL_BACKEND`` (read once per process)
            > the tensor's device

Per *field*: an unset field (``backend="auto"``, everything else ``None``)
falls through to the next layer, so a context only says what it changes.
:func:`resolve_execution` folds the layers into a finalized context.

Backends (``Backend``):

* ``"auto"`` — launch the CUDA kernel for a CUDA tensor, take the plain
  PyTorch version for a CPU tensor. The tensor's device decides, nothing
  else: there is no fallback from a failed kernel to the plain version. A
  resolved context may keep ``"auto"``: the device is the last layer of the
  order (:func:`tensor_route`).
* ``"torch"`` — the plain version, only when a caller asks for it (the
  tests, and ``chip_smoke.py``'s kernel-vs-plain comparisons).
* ``"cuda"`` — the kernel; raises for a CPU tensor.

Fields: ``backend`` and ``profile`` (:mod:`repro_torch.obs.profiling`'s
gate) are honoured. ``block_b`` (the rows a block owns) and ``segment``
(the butterfly backward's checkpoint interval, ``None`` = ⌈√p⌉) fold as
the reference's do and go to the tile rule
(:mod:`repro_torch.kernels.tuning`), which honours them in the launch or
refuses them with ``ValueError`` before any launch: the butterfly
backward's tile rows are a launch parameter, the other tiles are compiled
in, and the backward's register schedule takes ⌈√p⌉ alone.
``mesh_shape`` opts into multi-device execution: resolution builds the
mesh (:func:`repro_torch.launch.mesh.butterfly_mesh`, ``(d,)`` ->
``("data",)``, ``(p, d)`` -> ``("pod", "data")``) unless ``mesh``, a
prebuilt :class:`~repro_torch.launch.mesh.Mesh`, is given, which wins; an
ambient sharding context's mesh (:mod:`repro_torch.runtime.sharding`) is
reused when it has the requested shape. ``mesh_axes`` names the axes to
shard over. A context with a mesh routes the butterfly entry points
through :mod:`repro_torch.runtime.butterfly_sharding`. The reference's
``vmem_budget`` and ``flash_block_q`` have no torch meaning and are left
out: the tile rule's budget is the card's opt-in shared memory, and the
flash kernels' tiles are their own.

The ambient stack is per thread (``threading.local``): the router's driver
thread and the async client run kernels off the main thread, and one
thread's ``with use_execution(...)`` must not reroute another's calls.

A finalized context (one :func:`resolve_execution` returned) keeps its
backend and its mesh (a shard's :meth:`ExecutionContext.local` context
stays local under the caller's mesh block). Passed as the explicit layer
again it comes back as it is when no
ambient block is open, or when the innermost block is that same context;
under another block, the block and then the default fill the fields it
leaves unset (``segment``, ``profile``), as the reference refolds. The
``Trainer`` and the serving engine resolve once at construction and pass
theirs down, so a kernel call on their hot path pays no fold. An engine's
ticks run under :func:`frozen_execution` of its context, which sets this
thread's stack aside: a tick, replayed from a CUDA graph or run eagerly,
never reads an ambient block entered after construction.

:func:`resolve_device` is the entry points' device rule: ``None`` means
``cuda``, and asking for ``cuda`` without a card raises instead of running
on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from dataclasses import dataclass
from typing import Any, Literal, Optional, Tuple, Union

import torch

__all__ = [
    "Backend",
    "BACKENDS",
    "ExecutionContext",
    "clear_backend_cache",
    "current_execution",
    "frozen_execution",
    "resolve_backend",
    "resolve_device",
    "resolve_execution",
    "requests_mesh",
    "resolve_for_device",
    "route_context",
    "tensor_route",
    "use_execution",
]

Backend = Literal["auto", "torch", "cuda"]

BACKENDS = ("auto", "torch", "cuda")

ContextLike = Union["ExecutionContext", str, None]


# ---------------------------------------------------------------------------
# Backend resolution (cached REPRO_KERNEL_BACKEND read)
# ---------------------------------------------------------------------------

_ENV_UNREAD = "\x00unread"
_env_backend_cache: str = _ENV_UNREAD


def _env_backend() -> str:
    """``REPRO_KERNEL_BACKEND``, read from the environment once per process,
    so that the variable cannot flip mid-process and split a model across
    two backends."""
    global _env_backend_cache
    if _env_backend_cache == _ENV_UNREAD:
        _env_backend_cache = os.environ.get(
            "REPRO_KERNEL_BACKEND", "").strip().lower()
    return _env_backend_cache


def clear_backend_cache() -> None:
    """Forget the cached ``REPRO_KERNEL_BACKEND`` read (tests only: a test
    that sets the variable calls this before and after)."""
    global _env_backend_cache
    _env_backend_cache = _ENV_UNREAD


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one "
                         f"of {BACKENDS}")


def resolve_backend(backend: Backend = "auto") -> str:
    """A concrete ``backend`` is validated and returned as is; ``"auto"``
    falls through to the cached ``REPRO_KERNEL_BACKEND`` read, and stays
    ``"auto"`` (route by the tensor's device) when the variable is unset or
    ``auto``."""
    if backend == "auto":
        env = _env_backend()
        if env and env != "auto":
            backend = env
    _check_backend(backend)
    return backend


def tensor_route(backend: str, tensor: torch.Tensor) -> str:
    """The route (``"cuda"`` or ``"torch"``) for ``tensor`` under a resolved
    ``backend``."""
    if backend == "auto":
        return "cuda" if tensor.is_cuda else "torch"
    if backend == "torch":
        return "torch"
    if backend == "cuda":
        if not tensor.is_cuda:
            raise ValueError("backend='cuda' needs CUDA tensors, got a "
                             f"tensor on {tensor.device}")
        return "cuda"
    raise ValueError(f"unknown backend {backend!r}; expected one of "
                     f"{BACKENDS}")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


# ---------------------------------------------------------------------------
# The context object
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ExecutionContext:
    """Execution policy for the port's kernels.

    * ``backend`` — ``"auto" | "torch" | "cuda"`` (``"auto"`` = unset).
    * ``block_b`` — the rows a block owns; ``None`` = the tile rule's
      choice (:func:`repro_torch.kernels.tuning.resolve_block_b`, which
      honours or refuses it).
    * ``segment`` — the butterfly backward's checkpoint interval; ``None``
      = ⌈√p⌉, the only value its kernel takes (another is refused by the
      tile rule). The sandwich backward takes products with the truncated
      factors and has no stage schedule, so it does not read it.
    * ``profile`` — ``torch.profiler.record_function`` ranges around the
      kernel call sites (:mod:`repro_torch.obs.profiling`); ``None`` =
      unset: the ``REPRO_PROFILE`` variable, default off.
    * ``mesh_shape`` — opt-in multi-device execution: ``(2,)`` builds a
      ``("data",)`` mesh, ``(2, 2)`` a ``("pod", "data")`` mesh
      (:func:`repro_torch.launch.mesh.butterfly_mesh`); activations shard
      by rows with replicated weights and all-reduced weight gradients.
    * ``mesh`` — a prebuilt :class:`~repro_torch.launch.mesh.Mesh`; wins
      over ``mesh_shape``.
    * ``mesh_axes`` — the mesh axes to shard over (default: the ``("pod",
      "data")`` candidates present in the mesh).

    Hashable and frozen: safe to key caches on and to store on a module
    (:class:`repro_torch.nn.ButterflyLinear`).
    """

    backend: str = "auto"
    block_b: Optional[int] = None
    segment: Optional[int] = None
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axes: Optional[Tuple[str, ...]] = None
    mesh: Optional[Any] = None
    profile: Optional[bool] = None

    def __post_init__(self):
        _check_backend(self.backend)
        if self.mesh_shape is not None:
            object.__setattr__(self, "mesh_shape",
                               tuple(int(s) for s in self.mesh_shape))
        if self.mesh_axes is not None:
            object.__setattr__(self, "mesh_axes",
                               tuple(str(a) for a in self.mesh_axes))

    # -- composition ------------------------------------------------------

    @classmethod
    def coerce(cls, value: ContextLike) -> Optional["ExecutionContext"]:
        """``None`` | backend string | context -> context (or ``None``):
        ``butterfly_apply(x, w, context="torch")``."""
        if value is None or isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls(backend=value)
        raise TypeError(
            f"context must be an ExecutionContext, a backend string, or "
            f"None; got {type(value).__name__}")

    @classmethod
    def from_butterfly_config(cls, bc) -> "ExecutionContext":
        """The config layer of the resolution order: the execution fields
        of a :class:`repro_torch.configs.base.ButterflyConfig` (or
        ``None``)."""
        if bc is None:
            return cls()
        return cls(backend=bc.backend, block_b=bc.block_b,
                   segment=bc.segment, mesh_shape=bc.mesh_shape)

    def over(self, base: Optional["ExecutionContext"]
             ) -> "ExecutionContext":
        """This context's set fields over ``base``'s (field-wise overlay)."""
        if base is None or base == _UNSET:
            return self
        kw = {}
        for f in dataclasses.fields(self):
            mine = getattr(self, f.name)
            kw[f.name] = mine if mine != f.default else getattr(base, f.name)
        return ExecutionContext(**kw)

    def local(self) -> "ExecutionContext":
        """The same policy without the mesh: what one shard of a sharded
        region runs, so that a shard never routes again. The local context
        of a finalized one is finalized (and keeps having no mesh under a
        caller's mesh block)."""
        if self.mesh is None and self.mesh_shape is None:
            return self
        ctx = dataclasses.replace(self, mesh=None, mesh_shape=None)
        return _finalized(ctx) if getattr(self, "_final", False) else ctx

    # -- introspection ----------------------------------------------------

    def mesh_layout(self) -> str:
        """The resolved mesh as ``"data=2"`` or ``"pod=2,data=2"`` (``""``
        without one)."""
        return self.mesh.describe() if self.mesh is not None else ""

    def describe(self) -> str:
        """One-line summary of every set field (logs, ``TrainResult``)."""
        parts = [f"backend={self.backend}"]
        for name in ("block_b", "segment"):
            v = getattr(self, name)
            if v is not None:
                parts.append(f"{name}={v}")
        if self.mesh is not None:
            parts.append(f"mesh={self.mesh_layout()}")
        elif self.mesh_shape is not None:
            parts.append(f"mesh_shape={self.mesh_shape}")
        if self.mesh_axes is not None:
            parts.append(f"mesh_axes={self.mesh_axes}")
        if self.profile is not None:
            parts.append(f"profile={self.profile}")
        return " ".join(parts)


_UNSET = ExecutionContext()


# ---------------------------------------------------------------------------
# Ambient context, one stack per thread
# ---------------------------------------------------------------------------

_LOCAL = threading.local()


def _stack() -> list:
    """This thread's stack of folded ambient contexts (innermost last)."""
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class use_execution:
    """``with use_execution(ctx):`` — install an ambient execution context
    for this thread. Every kernel entry point, layer and model called inside
    the block sees ``ctx`` at the ambient layer of the resolution order.
    Blocks nest: the inner context's set fields win, unset fields fall
    through to the outer block. Another thread's stack is untouched."""

    def __init__(self, context: ContextLike):
        ctx = ExecutionContext.coerce(context)
        self.ctx = ctx if ctx is not None else ExecutionContext()

    def __enter__(self) -> ExecutionContext:
        stack = _stack()
        stack.append(self.ctx.over(stack[-1]) if stack else self.ctx)
        return self.ctx

    def __exit__(self, *exc):
        _stack().pop()
        return False


class frozen_execution:
    """``with frozen_execution(ctx):`` — run a block under ``ctx`` alone:
    this thread's ambient stack is set aside and holds only ``ctx`` until
    the block ends, so no block entered by a caller reaches the calls
    inside. The serving engine ticks under it, because a CUDA graph replay
    could not honour such a block either."""

    def __init__(self, context: ExecutionContext):
        self.ctx = context

    def __enter__(self) -> ExecutionContext:
        self.saved = _stack()
        _LOCAL.stack = [self.ctx]
        return self.ctx

    def __exit__(self, *exc):
        _LOCAL.stack = self.saved
        return False


def current_execution() -> Optional[ExecutionContext]:
    """This thread's folded ambient context (innermost set fields win), or
    ``None``."""
    stack = _stack()
    return stack[-1] if stack else None


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------

def _resolve_mesh(merged: ExecutionContext):
    """``merged.mesh``, else the mesh of ``merged.mesh_shape`` (``None``
    without one): an ambient sharding context's when its layout is that
    shape (a context that asks for another shape wins over the ambient
    mesh), else :func:`~repro_torch.launch.mesh.butterfly_mesh`'s."""
    if merged.mesh is not None:
        return merged.mesh
    if merged.mesh_shape is None:
        return None
    from repro_torch.runtime import sharding as rsharding
    sctx = rsharding.active_ctx()
    if (sctx is not None and sctx.mesh is not None
            and tuple(sctx.mesh.shape.values()) == merged.mesh_shape):
        return sctx.mesh
    from repro_torch.launch.mesh import butterfly_mesh
    return butterfly_mesh(merged.mesh_shape)


def _fold(context: ContextLike, default: ContextLike) -> ExecutionContext:
    """The explicit layer over this thread's ambient stack over
    ``default``, unresolved."""
    ctx = ExecutionContext.coerce(context) or _UNSET
    return ctx.over(current_execution()).over(
        ExecutionContext.coerce(default))


def requests_mesh(context: ContextLike = None,
                  default: ContextLike = None) -> bool:
    """Whether ``context`` over ``default`` sets a mesh field (``mesh``,
    ``mesh_shape`` or ``mesh_axes``), decided without building a mesh (the
    serving engine's refusal of a mesh on an arch without butterfly
    sites)."""
    merged = _fold(context, default)
    return any(f is not None for f in (merged.mesh, merged.mesh_shape,
                                       merged.mesh_axes))


def resolve_execution(context: ContextLike = None,
                      default: ContextLike = None) -> ExecutionContext:
    """Fold the resolution order into one finalized context.

    ``context`` is the explicit per-call layer, ``default`` the layer/config
    layer (e.g. :meth:`ExecutionContext.from_butterfly_config`); this
    thread's ambient stack sits between them. The result has a validated
    backend (``"auto"`` still routes by the tensor's device) and a built
    ``mesh`` or ``None`` (:func:`_resolve_mesh`; a mesh larger than the
    world raises ``RuntimeError``). Idempotent. A finalized context passed
    as ``context`` keeps its backend and its mesh, and comes back as it is
    unless an ambient block other than itself is open: then the block, and
    then ``default``, fill its other unset fields. ``block_b`` and
    ``segment`` go on to the tile rule at the call.
    """
    ctx = ExecutionContext.coerce(context)
    if ctx is not None and getattr(ctx, "_final", False):
        ambient = current_execution()
        if ambient is None or ambient is ctx:
            return ctx
        merged = ctx.over(ambient).over(ExecutionContext.coerce(default))
        merged = dataclasses.replace(
            merged, backend=ctx.backend, mesh=ctx.mesh,
            mesh_shape=ctx.mesh_shape, mesh_axes=ctx.mesh_axes)
        if merged == ctx:
            return ctx
        return _finalized(merged)
    merged = _fold(ctx, default)
    return _finalized(dataclasses.replace(
        merged, backend=resolve_backend(merged.backend),
        mesh=_resolve_mesh(merged)))


def resolve_for_device(context: ContextLike = None,
                       device: Union[str, torch.device, None] = None,
                       default: ContextLike = None) -> ExecutionContext:
    """:func:`resolve_execution`, with ``"auto"`` turned into the route of
    ``device`` (``"cuda"`` on a CUDA device, ``"torch"`` on the CPU): what
    the ``Trainer`` and the serving engine resolve once and freeze. A
    ``"cuda"`` backend for a CPU device raises ``ValueError``."""
    ctx = resolve_execution(context, default)
    route = "cuda" if torch.device(device).type == "cuda" else "torch"
    if ctx.backend == "auto":
        return _finalized(dataclasses.replace(ctx, backend=route))
    if ctx.backend == "cuda" and route != "cuda":
        raise ValueError(f"execution backend 'cuda' needs a CUDA device, got "
                         f"{device}")
    return ctx


def _finalized(ctx: ExecutionContext) -> ExecutionContext:
    object.__setattr__(ctx, "_final", True)
    return ctx


_ROUTES = {r: _finalized(ExecutionContext(backend=r))
           for r in ("torch", "cuda")}


def route_context(route: str) -> ExecutionContext:
    """The finalized context of a concrete route (``"torch"`` or
    ``"cuda"``) and nothing else. An autograd Function's backward runs on
    whatever thread autograd picks (a device thread for CUDA tensors), so
    it calls the backward kernels with the route its forward took, never
    with that thread's ambient stack."""
    return _ROUTES[route]
