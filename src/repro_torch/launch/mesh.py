"""Meshes: the ranks of the world laid out on named axes.

Counterpart of ``repro.launch.mesh``. A JAX mesh arranges devices; the
port's :class:`Mesh` arranges ranks, one process a device
(:mod:`repro_torch.runtime.dist`), over the first ``prod(shape)`` ranks of
the world, as the reference takes ``devices[:ndev]``. It holds a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names, answers ``mesh.shape`` as the ordered ``{axis: size}`` the
reference's does, and gives the process group of any set of its axes
(:meth:`Mesh.group`): one axis's from the ``DeviceMesh``, several axes'
built at construction. Building a mesh of more than one rank is collective:
every rank of the world builds it, in the same order, those outside it
included (:attr:`Mesh.coordinate` is ``None`` there). A mesh larger than
the world raises ``RuntimeError`` naming both ways to get the ranks:
``--simulated-devices N`` and ``torchrun``. A mesh of one rank needs no
world.

:func:`make_production_mesh` is a function, not a module constant, so
that importing this module joins no world.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.runtime import dist as rdist

__all__ = ["Mesh", "butterfly_mesh", "make_mesh", "make_production_mesh",
           "parse_mesh_shape", "production_layout", "simulated_mesh",
           "single_device_mesh"]


def _too_few(what: str, ndev: int) -> RuntimeError:
    return RuntimeError(
        f"{what} needs {ndev} ranks but the world has {rdist.world_size()}; "
        f"use a smaller mesh on this host, or start {ndev} ranks: "
        f"--simulated-devices {ndev} (launch/train.py, launch/serve.py; "
        f"runtime.dist.spawn_ranks) on one host, or torchrun "
        f"--nproc-per-node {ndev} ... --distributed")


class Mesh:
    """The first ``prod(shape)`` ranks of the world on the named ``axes``,
    row-major (rank ``r`` at ``unravel_index(r, shape)``). ``what`` names
    the mesh in the error a world too small for it raises."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], *,
                 what: str = ""):
        shape = tuple(int(s) for s in shape)
        axes = tuple(str(a) for a in axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} must "
                             f"pair up, one distinct name a dimension")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh shape {shape} has an empty dimension")
        self._shape = dict(zip(axes, shape))
        self.size = math.prod(shape)
        if self.size > rdist.world_size():
            raise _too_few(what or f"mesh {shape}", self.size)
        me = rdist.rank()
        self.coordinate: Optional[Tuple[int, ...]] = (
            tuple(int(c) for c in torch.unravel_index(
                torch.tensor(me), shape)) if me < self.size else None)
        self.device_mesh = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        if self.size > 1:
            self._build_groups()

    def _build_groups(self) -> None:
        """The ``DeviceMesh`` (one group an axis) and a group for every set
        of two or more axes: every rank of the world creates each group,
        in the same order, and keeps those it belongs to."""
        from torch.distributed.device_mesh import DeviceMesh
        world = rdist.current_world()
        dtype = world.device.type if world is not None else "cpu"
        layout = torch.arange(self.size).view(tuple(self._shape.values()))
        self.device_mesh = DeviceMesh(dtype, layout,
                                      mesh_dim_names=self.axis_names)
        names = self.axis_names
        for k in range(2, len(names) + 1):
            for subset in itertools.combinations(names, k):
                keep = [i for i, a in enumerate(names) if a not in subset]
                moved = layout.permute(*keep, *[names.index(a)
                                                for a in subset])
                for ranks in moved.reshape(-1, math.prod(
                        self._shape[a] for a in subset)).tolist():
                    group = dist.new_group(ranks=ranks)
                    if dist.get_rank() in ranks:
                        self._groups[subset] = group

    # -- the reference's surface ------------------------------------------

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis: size}`` in axis order, as ``jax.sharding.Mesh.shape``."""
        return dict(self._shape)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self._shape)

    # -- groups -------------------------------------------------------------

    def group(self, axes: Sequence[str]):
        """The process group of this rank along ``axes``: the ranks that
        share its coordinates on every other axis. Raises on a rank outside
        the mesh, or for a one-rank mesh (which never shards)."""
        axes = tuple(a for a in self.axis_names if a in tuple(axes))
        if self.coordinate is None:
            raise RuntimeError(f"rank {rdist.rank()} is not in the mesh "
                               f"{self.describe()}")
        if self.device_mesh is None:
            raise RuntimeError("a one-rank mesh has no process groups")
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self._groups[axes]

    def shard_index(self, axes: Sequence[str]) -> int:
        """This rank's position along ``axes``, row-major over them (the
        shard ``shard_map`` would give it for ``P(axes)``)."""
        if self.coordinate is None:
            raise RuntimeError(f"rank {rdist.rank()} is not in the mesh "
                               f"{self.describe()}")
        idx = 0
        for a, c in zip(self.axis_names, self.coordinate):
            if a in axes:
                idx = idx * self._shape[a] + c
        return idx

    def describe(self) -> str:
        """``"data=2"`` or ``"pod=2,data=2"``."""
        return ",".join(f"{a}={s}" for a, s in self._shape.items())

    def __repr__(self) -> str:
        return f"Mesh({self.describe()})"

    def __reduce__(self):
        # sent to another process (a rank's result): the layout without the
        # groups, which belong to this process's world
        return (_Layout, (tuple(self._shape.values()), self.axis_names))


class _Layout(Mesh):
    """A mesh's layout outside the world it was built in: shape, axes and
    :meth:`describe`, no groups."""

    def __init__(self, shape, axes):
        self._shape = dict(zip(axes, shape))
        self.size = math.prod(shape)
        self.coordinate = None
        self.device_mesh = None
        self._groups = {}


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """General mesh helper (tests, the elastic re-mesh planner)."""
    return Mesh(shape, axes)


def single_device_mesh() -> Mesh:
    """1-rank mesh with the production axis names (smoke tests)."""
    return make_mesh((1, 1), ("data", "model"))


def _production(multi_pod: bool) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single-pod 16x16 (data, model) or 2-pod 2x16x16 (pod, data, model):
    256 or 512 ranks."""
    shape, axes = _production(multi_pod)
    return Mesh(shape, axes, what=f"production mesh {shape}")


def production_layout(*, multi_pod: bool = False) -> Mesh:
    """The production mesh's layout alone (shape and axes, no ranks and no
    groups): what the dry-run's accounting reads, which needs no world of
    256 or 512 ranks."""
    return _Layout(*_production(multi_pod))


def parse_mesh_shape(text: str) -> Tuple[int, ...]:
    """A CLI's ``--mesh-shape``: ``"2"`` -> ``(2,)`` (a ``("data",)``
    mesh), ``"1x2"`` -> ``(1, 2)`` (``("pod", "data")``); ``SystemExit``
    with the reference's message otherwise."""
    try:
        shape = tuple(int(s) for s in text.split("x"))
        if not shape or any(s <= 0 for s in shape):
            raise ValueError(shape)
    except ValueError:
        raise SystemExit(
            f"invalid --mesh-shape {text!r}: expected e.g. "
            f"'8' (data mesh) or '2x4' (pod x data)") from None
    return shape


def simulated_mesh(ndev: int = 8, axes: Sequence[str] = ("data",),
                   shape: Optional[Sequence[int]] = None) -> Mesh:
    """Data-parallel mesh over ``ndev`` ranks of this host's world
    (:func:`repro_torch.runtime.dist.spawn_ranks`). ``shape`` defaults to
    ``(ndev,)`` for a single axis; several axes need an explicit shape
    whose product is ``ndev``."""
    axes = tuple(axes)
    if shape is None:
        if len(axes) != 1:
            raise ValueError(
                f"simulated_mesh needs an explicit shape for axes {axes}")
        shape = (ndev,)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != ndev:
        raise ValueError(f"shape {shape} does not use {ndev} devices")
    return Mesh(shape, axes, what=f"simulated mesh {shape}")


@functools.lru_cache(maxsize=None)
def butterfly_mesh(mesh_shape: Tuple[int, ...]) -> Mesh:
    """Mesh for ``ButterflyConfig.mesh_shape``: ``(d,)`` -> ``("data",)``,
    ``(p, d)`` -> ``("pod", "data")``. Cached per shape (and cleared when
    the world is left), so every caller of a shape shares one mesh and its
    groups."""
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if len(mesh_shape) == 1:
        axes: Tuple[str, ...] = ("data",)
    elif len(mesh_shape) == 2:
        axes = ("pod", "data")
    else:
        raise ValueError(
            f"butterfly mesh_shape must be (data,) or (pod, data); got "
            f"{mesh_shape}")
    return Mesh(mesh_shape, axes, what=f"butterfly mesh_shape {mesh_shape}")
