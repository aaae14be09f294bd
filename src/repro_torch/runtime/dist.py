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
  context, a TCP store the caller holds on a free local port), runs ``fn(*args)`` in each and returns each
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

import datetime
import os
import queue
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Union

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


def init_world(rank: int, size: int, init_method: Union[str, dist.Store],
               device: str = "cuda", local_rank: Optional[int] = None,
               local_size: Optional[int] = None,
               timeout: Optional[float] = None) -> World:
    """Join a world of ``size`` ranks as ``rank`` through ``init_method``
    (``tcp://host:port``, or a ``torch.distributed.Store`` the ranks
    share). ``device`` is ``"cuda"`` (the default; raises
    without a card) or ``"cpu"``; a CUDA rank runs on its own card
    ``cuda:<local_rank>`` over NCCL when this host's ``local_size`` ranks
    each have one, else on ``cuda:<local_rank mod cards>`` over gloo.
    ``timeout`` (seconds, ``None`` = torch's default) bounds each
    collective of the world: a rank left waiting for a peer that never
    issues its side fails instead of hanging."""
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
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    if isinstance(init_method, dist.Store):
        kw["store"] = init_method
    else:
        kw["init_method"] = init_method
    dist.init_process_group(backend, rank=rank, world_size=size, **kw)
    _WORLD = World(rank=rank, size=size, backend=backend, device=dev)
    return _WORLD


def init_from_env(device: Optional[str] = None) -> World:
    """Join the world that ``torchrun`` describes in the environment.
    ``device`` ``None`` means ``"cuda"``, which raises without a card
    (:func:`~repro_torch.kernels.context.resolve_device`'s rule); pass
    ``"cpu"`` for CPU ranks."""
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in env]
    if missing:
        raise RuntimeError(f"--distributed needs the variables torchrun "
                           f"sets; missing {', '.join(missing)}")
    size = int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", env["RANK"]))
    local_size = int(env.get("LOCAL_WORLD_SIZE", size))
    return init_world(int(env["RANK"]), size,
                      f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                      "cuda" if device is None else device, local_rank,
                      local_size)


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
               group_timeout: Optional[float], fn: Callable, args: Sequence,
               results) -> None:
    """One spawned rank: join the world, run ``fn(*args)``, put
    ``(rank, ok, result or traceback)`` on ``results``, leave."""
    try:
        torch.set_num_threads(threads)
        store = dist.TCPStore("localhost", port, n, is_master=False)
        init_world(rank, n, store, device, timeout=group_timeout)
        results.put((rank, True, fn(*args)))
    except BaseException:               # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


def spawn_ranks(n: int, fn: Callable, *args: Any, device: str = "cuda",
                threads: Optional[int] = None, timeout: float = 1800.0,
                group_timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(*args)`` in ``n`` new ranks of one world on this host and
    return their results in rank order. ``fn`` and ``args`` are pickled
    (``fn`` by its import path: a function of a module, not of
    ``__main__``). ``device``: ``"cuda"`` (the default: NCCL when the host
    has a card for each rank, else all ranks on ``cuda:0`` over gloo;
    raises before any rank starts when there is no card) or ``"cpu"``
    (gloo). ``threads``: torch's intra-op threads a rank (default: this
    process's, shared out). Raises ``RuntimeError`` with the rank's
    traceback when a rank fails, exits without a result, or the ranks
    outlast ``timeout`` seconds; every rank is stopped before it returns or
    raises. ``group_timeout`` is :func:`init_world`'s ``timeout`` in every
    rank: a collective that one rank never matches fails its peers after
    that many seconds, so a divergence fails rather than hangs."""
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but no CUDA device is "
                           "available; pass device='cpu' for CPU ranks")
    if threads is None:
        threads = max(1, torch.get_num_threads() // n)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    # the world's store, held here from bind to the end: a port freed and
    # bound again later could be taken meanwhile by another world on this
    # host, whose ranks would then meet these in one store
    store = dist.TCPStore("localhost", 0, n, is_master=True,
                          wait_for_workers=False)
    port = store.port
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, port, device, threads, group_timeout,
                               fn, args, results), name=f"rank{r}")
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
        del store
    return [got[r] for r in range(n)]
