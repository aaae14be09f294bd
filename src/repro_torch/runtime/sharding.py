"""Logical-axis sharding rules with divisibility-aware fallback.

Counterpart of ``repro.runtime.sharding``. A *rule set* maps logical axis
names (``"embed"``, ``"heads"``, ``"vocab"``, ``"experts"``, ``"batch"``,
``"seq_kv"``, ...) to mesh axes (a name, a tuple of names, or None).
:func:`logical_to_pspec` resolves a ParamSpec or activation axis tuple into
a :class:`PartitionSpec`, enforcing:

  * divisibility — if a dim is not divisible by the mesh-axis product, the
    mesh axes are dropped for that dim (replicate rather than mis-shard;
    e.g. 8 KV heads on a 16-way model axis);
  * uniqueness — a mesh axis may appear at most once per spec; later uses
    are dropped.

A mesh here is anything with the reference's ``mesh.shape`` (an ordered
``{axis: size}``): the port's :class:`~repro_torch.launch.mesh.Mesh`, or a
stand-in in tests. :class:`PartitionSpec` is the port's own tuple with the
reference's entries, so specs compare equal entry for entry with
``jax.sharding.PartitionSpec``'s.

The ambient :class:`ShardingCtx` stack is per thread, as the port's
execution stack is (:mod:`repro_torch.kernels.context`): the Trainer opens
it around its steps, and execution resolution reuses its mesh.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.runtime import pytree as pt

__all__ = ["BUTTERFLY_AXES", "DEFAULT_RULES", "PartitionSpec",
           "ShardingCtx", "active_ctx", "batch_axes", "carry_ctx",
           "constrain",
           "logical_to_pspec", "resolve_axis", "spec_pspecs",
           "use_sharding"]

MeshAxes = Union[None, str, Tuple[str, ...]]
RuleSet = Mapping[str, MeshAxes]

# Default production rule set: DP(+pod) on batch, FSDP on embed, TP on
# heads/mlp/vocab, EP on experts, SP on sequence, KV-cache seq on model.
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "embed": ("pod", "data"),   # FSDP/ZeRO shard (incl. the DCN pod axis)
    "embed_no_fsdp": None,
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    # fallback TP shard for GQA weights when kv_heads doesn't divide the
    # model axis (e.g. kv=8 on a 16-way axis): shard the head_dim instead
    "head_dim": "model",
    "mlp": "model",
    "experts": "model",         # EP
    "expert_mlp": None,
    "seq": None,                # activation seq (train): replicated
    "seq_sp": "model",          # sequence-parallel residual stream
    "seq_kv": "model",          # KV-cache sequence shard
    "rnn_state": "model",
    "conv": None,
    # Butterfly sandwich params (repro_torch.core.layers): O(n log n)
    # weights, replicated on every rank; the distributed path shards the
    # *rows* and all-reduces the weight gradients instead
    # (repro_torch.runtime.butterfly_sharding).
    "stages": None,
    "butterfly_pair": None,
    "butterfly_n": None,
    "butterfly_core_out": None,
    "butterfly_core_in": None,
    "butterfly_bias": None,
}

# Logical axis names introduced by the butterfly layers.
BUTTERFLY_AXES: Tuple[str, ...] = (
    "stages", "butterfly_pair", "butterfly_n", "butterfly_core_out",
    "butterfly_core_in", "butterfly_bias")


class PartitionSpec(tuple):
    """One entry a dim: ``None`` (replicated), a mesh axis, or a tuple of
    mesh axes; trailing ``None`` entries are dropped, as the reference's
    specs are built."""

    def __new__(cls, *parts: MeshAxes) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _axes_tuple(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def resolve_axis(name: Optional[str], dim: int, mesh, rules: RuleSet,
                 used: set) -> MeshAxes:
    """Resolve one logical axis to mesh axes honoring divisibility and
    uniqueness (a greedy prefix of the rule's axes that divides ``dim``)."""
    if name is None:
        return None
    entry = rules.get(name, None)
    shape = mesh.shape
    axes = [a for a in _axes_tuple(entry) if a in shape and a not in used]
    chosen = []
    prod = 1
    for a in axes:
        if dim % (prod * shape[a]) == 0:
            chosen.append(a)
            prod *= shape[a]
    if not chosen:
        return None
    used.update(chosen)
    return chosen[0] if len(chosen) == 1 else tuple(chosen)


def logical_to_pspec(axes: Sequence[Optional[str]], shape: Sequence[int],
                     mesh, rules: RuleSet) -> PartitionSpec:
    used: set = set()
    out = [resolve_axis(n, d, mesh, rules, used)
           for n, d in zip(axes, shape)]
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def spec_pspecs(specs: Any, mesh, rules: RuleSet = DEFAULT_RULES) -> Any:
    """ParamSpec tree -> PartitionSpec tree (the tree's structure kept,
    leaves that are not specs passed through)."""
    return pt._map(
        lambda s: logical_to_pspec(s.axes or (None,) * len(s.shape),
                                   s.shape, mesh, rules)
        if pt.is_spec(s) else s, specs)


class ShardingCtx:
    """Explicit (mesh, rules) context threaded into model code."""

    def __init__(self, mesh, rules: RuleSet):
        self.mesh = mesh
        self.rules = dict(rules)


_LOCAL = threading.local()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class use_sharding:
    """``with use_sharding(mesh):`` — install an ambient sharding context
    for this thread."""

    def __init__(self, mesh, rules: RuleSet = DEFAULT_RULES):
        self.ctx = ShardingCtx(mesh, rules)

    def __enter__(self) -> ShardingCtx:
        _stack().append(self.ctx)
        return self.ctx

    def __exit__(self, *exc):
        _stack().pop()
        return False


def active_ctx() -> Optional[ShardingCtx]:
    stack = _stack()
    return stack[-1] if stack else None


def carry_ctx(fn):
    """``fn`` under this thread's ambient context as it is now, on whichever
    thread later calls it: a region that ``torch.utils.checkpoint``
    recomputes on the autograd engine's device thread (which has no
    ambient context of its own) sees the mesh its forward saw."""
    ctx = active_ctx()
    if ctx is None:
        return fn

    def run(*args, **kw):
        _stack().append(ctx)
        try:
            return fn(*args, **kw)
        finally:
            _stack().pop()
    return run


def constrain(x, axes: Sequence[Optional[str]]):
    """The identity. The reference's ``with_sharding_constraint`` is a
    layout hint to XLA's partitioner and changes no value; the port has no
    partitioner to hint: every rank holds the whole tensor, and the one
    sharded computation, the butterfly sites' rows, is cut and gathered
    explicitly (:mod:`repro_torch.runtime.butterfly_sharding`)."""
    return x


def batch_axes(mesh, rules: RuleSet, batch: int) -> PartitionSpec:
    """PartitionSpec for a (batch, ...) array sharded on the batch dim."""
    used: set = set()
    return PartitionSpec(resolve_axis("batch", batch, mesh, rules, used))
