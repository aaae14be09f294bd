"""The paged KV cache pool of the serving engine.

Counterpart of ``repro.serve.cache.PagedCachePool``: KV leaves are ONE
preallocated pool of fixed-size pages per layer stack, plus a host-side
per-slot page table and a FIFO free-list allocator with recycling.
Capacity is reserved per request (``prompt + max_new_tokens``), not per
worst-case ``max_len``.

The pool is one pair of ``(n_layers, num_pages, page_size, KV, D)`` tensors
(``{"k", "v"}``), updated **in place** by the model's attention; the
reference rebuilds its immutable arrays instead. It pages the ``self`` KV
of ``attn``, ``global`` and ``moe`` blocks. :func:`paged_supported` and
:func:`chunked_prefill_supported` are the reference's predicates. A pool
can be built without a model, so it refuses, as ``LM`` does, an arch
whose blocks the port does not build yet, naming its ROADMAP sub-item
(:func:`repro_torch.models.lm.check_ported`); the engine's refusal is
its pool's.

Physical **page 0 is the trash page**: never allocated, the target of every
unallocated page-table entry, and the engine redirects inactive slots'
whole rows to it. Stray writes land there; reads from it are masked by the
positional validity mask.

The page table lives on the host, where the allocator edits it, and in one
persistent device buffer that :meth:`PagedCachePool.gather_args` refreshes
in place: the engine's captured CUDA graphs read the table at that fixed
address.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.context import resolve_device
from repro_torch.kernels.paged_attention import TRASH_PAGE
from repro_torch.models import lm

#: block types whose cache mixes positions sequentially (recurrent state):
#: a right-padded prefill or a paged gather would corrupt them
SEQUENTIAL_STATE_BLOCKS = ("rec", "mlstm", "slstm")


class PoolExhausted(RuntimeError):
    """The page pool cannot cover a requested allocation. The engine
    catches it at admission and leaves the request queued."""


def paged_supported(cfg: ModelConfig) -> bool:
    """True when every cache of ``cfg`` is pageable or boundedly dense
    (the reference's predicate)."""
    types = set(cfg.block_unit) | set(cfg.tail_layers)
    return not (types & set(SEQUENTIAL_STATE_BLOCKS))


def chunked_prefill_supported(cfg: ModelConfig) -> bool:
    """True when prompts can be admitted as fixed-size prefill chunks:
    every self-attention cache paged (no sliding-window ring) and a plain
    token stream (no frontend prefix, no encoder); the reference's
    predicate."""
    types = set(cfg.block_unit) | set(cfg.tail_layers)
    return (paged_supported(cfg)
            and not (types & {"local", "xdec", "enc"})
            and not cfg.frontend and not cfg.n_enc_layers)


class PagedCachePool:
    """Fixed-size pages in one preallocated pool + per-slot page tables.

    ``num_pages`` counts physical pages including the trash page; the
    default matches a dense pool of the same ``slots``/``max_len`` plus the
    trash page. The free list is a FIFO deque: pages allocate in ascending
    id order from a fresh pool and recycle in the order they were freed.

    ``faults`` optionally holds a
    :class:`repro_torch.serve.faults.FaultInjector`; the pool consults it on
    every real allocation attempt, so a seeded schedule can force
    exhaustion even while free pages exist.
    """

    faults = None                      # Optional[FaultInjector]

    def __init__(self, cfg: ModelConfig, slots: int, max_len: int, *,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 device: Union[str, torch.device, None] = None):
        lm.check_ported(cfg)
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.slots = slots
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.pages_per_slot = math.ceil(self.max_len / self.page_size)
        if num_pages is None:
            num_pages = slots * self.pages_per_slot + 1
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is the "
                             f"trash page), got {num_pages}")
        self.num_pages = int(num_pages)
        self._free: collections.deque = collections.deque(
            range(1, self.num_pages))
        self._owned: List[List[int]] = [[] for _ in range(slots)]
        self._table = np.full((slots, self.pages_per_slot), TRASH_PAGE,
                              np.int32)
        self._device_table = torch.full(self._table.shape, TRASH_PAGE,
                                        dtype=torch.int32,
                                        device=self.device)
        self._hwm = 0

    # -- allocator ------------------------------------------------------

    def pages_for(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.page_size)

    def alloc_pages(self, slot: int, n_tokens: int) -> None:
        """Ensure ``slot`` owns pages covering positions [0, n_tokens)."""
        if n_tokens > self.max_len:
            raise PoolExhausted(
                f"slot page table holds {self.max_len} positions, request "
                f"needs {n_tokens}")
        owned = self._owned[slot]
        need = self.pages_for(n_tokens) - len(owned)
        if need <= 0:
            return
        if self.faults is not None:
            self.faults.check("pool.alloc")
        if need > len(self._free):
            raise PoolExhausted(
                f"pool has {len(self._free)} free pages, slot {slot} "
                f"needs {need} more (of {self.num_pages - 1} usable)")
        for _ in range(need):
            page = self._free.popleft()
            self._table[slot, len(owned)] = page
            owned.append(page)
        self._hwm = max(self._hwm, self.pages_in_use)

    def free(self, slot: int) -> None:
        """Recycle the slot's pages (FIFO) and trash its table row."""
        self._free.extend(self._owned[slot])
        self._owned[slot] = []
        self._table[slot, :] = TRASH_PAGE

    def gather_args(self) -> Dict[str, torch.Tensor]:
        """The page table (slots, pages_per_slot) int32 on the pool's
        device: the host table copied into the pool's one persistent
        device buffer, which is returned (the same tensor on every call)."""
        self._device_table.copy_(torch.from_numpy(self._table))
        return {"page_table": self._device_table}

    def page_row(self, slot: int) -> torch.Tensor:
        """The slot's page-table row (pages_per_slot,) int32 on the pool's
        device, unallocated entries on the trash page."""
        return torch.from_numpy(self._table[slot].copy()).to(self.device)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    @property
    def pages_hwm(self) -> int:
        return self._hwm

    @property
    def total_pages(self) -> int:
        return self.num_pages

    def reset_stats(self) -> None:
        """Rebase the high-water mark to the pages in use now."""
        self._hwm = self.pages_in_use

    def free_list(self) -> Tuple[int, ...]:
        return tuple(self._free)

    def slot_pages(self, slot: int) -> Tuple[int, ...]:
        return tuple(self._owned[slot])

    # -- the pool tensors -------------------------------------------------

    def init(self) -> Dict[str, torch.Tensor]:
        """Zeroed ``{"k", "v"}`` pools, (n_layers, N, ps, KV, D) each, in
        the compute dtype on the pool's device."""
        cfg = self.cfg
        shape = (cfg.n_layers, self.num_pages, self.page_size,
                 cfg.n_kv_heads, cfg.head_dim_)
        return {t: torch.zeros(shape, dtype=cfg.cdtype(), device=self.device)
                for t in ("k", "v")}

    def reset_slot(self, caches: Dict[str, torch.Tensor], slot: int
                   ) -> None:
        """Zero the slot's cache state in place, through its page row, in
        every layer: its own pages and, for the row's unallocated entries,
        the trash page (as the reference's scatter of a fresh cache does).
        Call before :meth:`free`, which sends the row to the trash page."""
        row = self.page_row(slot).long()
        for pool in caches.values():
            pool[:, row] = 0
