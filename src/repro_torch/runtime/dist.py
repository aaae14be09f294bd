"""Process groups for the port's multi-device paths: one process a device.

Counterpart of ``repro.launch._prejax`` (the CPU's simulated devices) and
of ``jax.distributed.initialize()``. JAX runs one program over many devices
from one controller; the port runs one process a device (a *rank*), joined
in a ``torch.distributed`` process group, and a mesh
(:mod:`repro_torch.launch.mesh`) lays the ranks out on named axes.

* :func:`init_from_env` joins the world that ``torchrun`` describes
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``): the training CLI's ``--distributed``.
* :func:`spawn_ranks` starts ``n`` ranks on this host (the ``spawn``
  context, a free local port), runs ``fn(*args)`` in each and returns each
  rank's result to the caller: the CLI's ``--simulated-devices N``, the
  tests and ``chip_smoke.py``. A rank that raises makes it raise with that
  rank's traceback, after it has stopped every rank it started.
* :func:`world_size`, :func:`rank` and :func:`current_world` describe the
  world (one rank, rank 0, when none was joined); :func:`shutdown` leaves
  it.

The backend is chosen by one rule (:func:`choose_backend`) and recorded in
the :class:`World`: NCCL when each rank owns its own card; gloo for CPU
ranks, and for ranks that share one card, which NCCL refuses. Gloo's
collectives on CUDA tensors are fewer than on CPU tensors; the sharded
sites build what they need from those it takes
(:mod:`repro_torch.runtime.butterfly_sharding`).
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["World", "choose_backend", "current_world", "init_world",
           "init_from_env", "rank", "shutdown", "spawn_ranks",
           "world_size"]


@dataclass(frozen=True)
class World:
    """The joined world as this rank sees it."""

    rank: int
    size: int
    backend: str
    device: torch.device

    def describe(self) -> str:
        return (f"rank {self.rank} of {self.size} on {self.device} over "
                f"{self.backend}")


_WORLD: Optional[World] = None


def choose_backend(device_type: str, ranks: int, cards: int) -> str:
    """``"nccl"`` when ``ranks`` CUDA ranks each own one of ``cards``
    cards, ``"gloo"`` for CPU ranks and for CUDA ranks sharing a card."""
    if device_type == "cuda" and cards >= ranks:
        return "nccl"
    return "gloo"


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def current_world() -> Optional[World]:
    """The world :func:`init_world` joined in this process, or ``None``."""
    return _WORLD


def init_world(rank: int, size: int, init_method: str,
               device: str = "cpu", local_rank: Optional[int] = None,
               local_size: Optional[int] = None) -> World:
    """Join a world of ``size`` ranks as ``rank`` through ``init_method``
    (``tcp://host:port``). ``device`` is ``"cpu"`` or ``"cuda"``; a CUDA
    rank runs on its own card ``cuda:<local_rank>`` over NCCL when this
    host's ``local_size`` ranks each have one, else on
    ``cuda:<local_rank mod cards>`` over gloo."""
    global _WORLD
    local_rank = rank if local_rank is None else local_rank
    local_size = size if local_size is None else local_size
    if device == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("device 'cuda' asked for, but no CUDA device "
                               "is available")
        backend = choose_backend("cuda", local_size, cards)
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    elif device == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    else:
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size)
    _WORLD = World(rank=rank, size=size, backend=backend, device=dev)
    return _WORLD


def init_from_env(device: Optional[str] = None) -> World:
    """Join the world that ``torchrun`` describes in the environment.
    ``device`` ``None`` means ``"cuda"`` where a card is visible, else
    ``"cpu"``."""
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in env]
    if missing:
        raise RuntimeError(f"--distributed needs the variables torchrun "
                           f"sets; missing {', '.join(missing)}")
    size = int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", env["RANK"]))
    local_size = int(env.get("LOCAL_WORLD_SIZE", size))
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return init_world(int(env["RANK"]), size,
                      f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                      device, local_rank, local_size)


def shutdown() -> None:
    """Leave the world (no-op when none was joined) and forget the meshes
    built over it."""
    global _WORLD
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD = None
    from repro_torch.launch import mesh
    mesh.butterfly_mesh.cache_clear()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, port: int, device: str, threads: int,
               fn: Callable, args: Sequence, results) -> None:
    """One spawned rank: join the world, run ``fn(*args)``, put
    ``(rank, ok, result or traceback)`` on ``results``, leave."""
    try:
        torch.set_num_threads(threads)
        init_world(rank, n, f"tcp://localhost:{port}", device)
        results.put((rank, True, fn(*args)))
    except BaseException:               # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


def spawn_ranks(n: int, fn: Callable, *args: Any, device: str = "cpu",
                threads: Optional[int] = None,
                timeout: float = 1800.0) -> List[Any]:
    """Run ``fn(*args)`` in ``n`` new ranks of one world on this host and
    return their results in rank order. ``fn`` and ``args`` are pickled
    (``fn`` by its import path: a function of a module, not of
    ``__main__``). ``device``: ``"cpu"`` (gloo) or ``"cuda"`` (NCCL when
    the host has a card for each rank, else all ranks on ``cuda:0`` over
    gloo). ``threads``: torch's intra-op threads a rank (default: this
    process's, shared out). Raises ``RuntimeError`` with the rank's
    traceback when a rank fails, exits without a result, or the ranks
    outlast ``timeout`` seconds; every rank is stopped before it returns or
    raises."""
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    if threads is None:
        threads = max(1, torch.get_num_threads() // n)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, port, device, threads, fn, args,
                               results), name=f"rank{r}")
             for r in range(n)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < n:
            try:
                r, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in got and p.exitcode is not None]
                if dead:
                    # a rank that died without a word (killed, or its
                    # result did not pickle): wait briefly for late puts
                    try:
                        r, ok, payload = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank(s) {dead} of {n} exited without a result "
                            f"(exit codes {[procs[i].exitcode for i in dead]})"
                        ) from None
                elif time.monotonic() > deadline:
                    raise RuntimeError(f"ranks still running after "
                                       f"{timeout:.0f} s") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {r} of {n} failed:\n{payload}")
            got[r] = payload
    finally:
        for p in procs:
            p.join(timeout=30.0 if len(got) == n else 0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results.close()
        results.join_thread()
    return [got[r] for r in range(n)]
