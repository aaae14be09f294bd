"""The serving engine's KV cache pools: dense and paged.

Counterpart of ``repro.serve.cache``. A pool's caches are one flat dict of
stacked tensors, updated **in place** by the model's attention (the
reference rebuilds its immutable trees instead), laid out per block type
as the reference lays them out:

=================  ==================================================
attn/global/moe    ``"k"``/``"v"`` (n, ...): a full row per slot on
                   :class:`DenseCachePool`, pages of one shared pool on
                   :class:`PagedCachePool` (the reference's
                   ``_PAGED_KEYS``)
xdec               its self-attention in ``"k"``/``"v"`` as above; its
                   encoder rows in ``"cross_k"``/``"cross_v"`` (n_xdec,
                   slots, enc_seq, KV, D), dense on either pool: a
                   prefill writes them, decode only reads them
enc                no cache: the encoder runs at prefill only
local              ``"ring_k"``/``"ring_v"`` (n_local, slots, ring, KV,
                   D): a dense ring of ``min(window, total_seq)``
                   positions per slot, on either pool
rec                ``"rec_h"`` (n, slots, R) float32, ``"rec_conv"`` (n,
                   slots, W-1, R): dense pool only
mlstm              ``"mlstm_C"`` (n, slots, H, D, D), ``"mlstm_n"``,
                   ``"mlstm_m"`` float32, ``"mlstm_conv"`` (n, slots,
                   W-1, DI): dense pool only
slstm              ``"slstm_c"``/``"_n"``/``"_m"``/``"_h"`` (n, slots,
                   E) float32: dense pool only
=================  ==================================================

Every entry starts at zeros but the xLSTM stabilizers and normalizer, as
the reference's init: ``mlstm_m`` and ``slstm_m`` at -1e30, ``slstm_n`` at
1e-6 (:func:`init_fill`); a slot's reset writes the same values.
:func:`repro_torch.models.lm.cache_index` maps each layer to its entries.
:func:`init_caches` is the dense layout at any batch: the dense pool's
caches, and the batch-1 tree a whole-prompt prefill fills before
``write_slot`` splices it into a slot. :func:`paged_supported` and
:func:`chunked_prefill_supported` are the reference's predicates;
:func:`make_pool` picks a pool as the reference's does. A pool can be
built without a model. ``total_seq`` counts a ``vision`` config's prefix
tokens: a row, a page table and a request's page budget hold them.

Physical **page 0 is the trash page**: never allocated, the target of every
unallocated page-table entry, and the engine redirects inactive slots'
whole rows to it. Stray writes land there; reads from it are masked by the
positional validity mask. Rings and dense rows are per slot: an inactive
slot's decode writes land in its own row, which admission rewrites whole.

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
from repro_torch.models import rglru as rgm
from repro_torch.models import xlstm as xm

#: block types whose cache mixes positions sequentially (recurrent state):
#: a right-padded prefill or a paged gather would corrupt them. The
#: cache's list; the engine's own (``repro_torch.serve.engine``) adds
#: ``local``, whose rings must be prefilled at exact lengths.
SEQUENTIAL_STATE_BLOCKS = ("rec", "mlstm", "slstm")

#: the block types whose ``self`` KV the paged pool pages
_PAGED_BLOCKS = ("attn", "global", "moe", "xdec")

Caches = Dict[str, torch.Tensor]


class PoolExhausted(RuntimeError):
    """The pool cannot cover a requested allocation. The engine catches it
    at admission and leaves the request queued."""


def total_seq(cfg: ModelConfig, seq_len: int) -> int:
    """Cache length: text tokens plus any prepended frontend tokens."""
    return seq_len + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)


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


#: each key of the caches whose init value is not zero
_INIT_FILL = {**{"mlstm_" + f: v for f, v in xm.MLSTM_INIT.items()},
              **{"slstm_" + f: v for f, v in xm.SLSTM_INIT.items()}}


def init_fill(key: str) -> float:
    """The init value of every element of the cache entry ``key``."""
    return _INIT_FILL.get(key, 0.0)


def layer_cache_spec(cfg: ModelConfig, btype: str, batch: int,
                     seq_len: int) -> rgm.StateSpec:
    """One layer's dense cache entries, ``{field: (shape, dtype, init
    value)}``: ``k`` and ``v`` ``(batch, length, KV, D)`` in the compute
    dtype, ``length`` the whole ``seq_len`` for full attention and
    ``min(sliding_window, seq_len)`` for a ``local`` ring; a recurrent
    block's state as the reference's ``rglru_cache_spec``,
    ``mlstm_cache_spec`` and ``slstm_cache_spec``; ``"cross"`` the ``k``
    and ``v`` of an ``xdec`` layer's ``enc_seq`` encoder rows."""
    if btype == "cross":
        shape = (batch, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim_)
        return {kv: (shape, cfg.cdtype(), 0.0) for kv in ("k", "v")}
    if btype == "rec":
        return rgm.cache_spec(cfg, batch)
    if btype == "mlstm":
        return xm.mlstm_cache_spec(cfg, batch)
    if btype == "slstm":
        return xm.slstm_cache_spec(cfg, batch)
    if btype not in ("attn", "local", "global", "moe", "xdec"):
        raise ValueError(f"{cfg.name}: no port cache for block type "
                         f"{btype!r}")
    length = (min(cfg.sliding_window, seq_len) if btype == "local"
              else seq_len)
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim_)
    return {kv: (shape, cfg.cdtype(), 0.0) for kv in ("k", "v")}


def _stacks(cfg: ModelConfig) -> Dict[str, Tuple[str, int]]:
    """``{prefix: (a block type of the stack, layers in it)}`` for the
    prefixes of :func:`repro_torch.models.lm.cache_index` in use, and
    ``"cross_"`` (type ``"cross"``) for the ``xdec`` layers' encoder
    rows."""
    out: Dict[str, Tuple[str, int]] = {}
    types = lm.layer_types(cfg)
    for t, (pre, _) in zip(types, lm.cache_index(cfg)):
        out[pre] = (t, out.get(pre, (t, 0))[1] + 1)
    if "xdec" in types:
        out["cross_"] = ("cross", types.count("xdec"))
    return out


def init_caches(cfg: ModelConfig, batch: int, seq_len: int,
                device: Union[str, torch.device, None] = None) -> Caches:
    """The caches in the dense layout at their init values: ``"k"``/``"v"``
    (n_full, batch, total_seq, KV, D), ``"ring_k"``/``"ring_v"`` (n_local,
    batch, ring, KV, D), ``"cross_k"``/``"cross_v"`` (n_xdec, batch,
    enc_seq, KV, D) and each recurrent state stack (n, batch, ...), each
    present when some layer uses it (:func:`layer_cache_spec`)."""
    dev = resolve_device(device)
    seq_len = total_seq(cfg, seq_len)
    out = {}
    for pre, (t, n) in _stacks(cfg).items():
        for f, (shape, dt, fill) in layer_cache_spec(cfg, t, batch,
                                                     seq_len).items():
            out[pre + f] = torch.full((n,) + shape, fill, dtype=dt,
                                      device=dev)
    return out


def write_cache_slot(pool: Caches, sub: Caches, slot: int,
                     keys: Optional[Tuple[str, ...]] = None) -> None:
    """Copy a batch-1 dense cache tree ``sub`` (:func:`init_caches`, filled
    by a prefill) into batch index ``slot`` of the dense-layout ``pool``,
    in place; ``keys`` limits the entries (all of ``pool``'s by default)."""
    for key in (pool if keys is None else keys):
        pool[key][:, slot] = sub[key][:, 0]


def reset_cache_slot(pool: Caches, slot: int,
                     keys: Optional[Tuple[str, ...]] = None) -> None:
    """Write batch index ``slot`` of the dense-layout ``pool`` back to its
    init values (:func:`init_fill`) in place."""
    for key in (pool if keys is None else keys):
        pool[key][:, slot] = init_fill(key)


def state_keys(caches: Caches) -> Tuple[str, ...]:
    """The entries of ``caches`` that hold recurrent state: a decode tick
    advances them, where it only writes K/V at its own position."""
    prefixes = tuple(t + "_" for t in lm.STATE_FIELDS)
    return tuple(k for k in caches if k.startswith(prefixes))


class DenseCachePool:
    """One full ``max_len`` row per slot (a ring per slot for ``local``
    layers, cross rows per slot for ``xdec`` ones, a state per slot for
    recurrent ones): the reference's
    ``DenseCachePool``, simple and exact. No pages: the allocator only
    checks that a request fits a row, and there is nothing to gather."""

    kind = "dense"
    faults = None                      # never consulted: no allocation

    def __init__(self, cfg: ModelConfig, slots: int, max_len: int, *,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.slots = slots
        self.max_len = int(max_len)

    def init(self) -> Caches:
        return init_caches(self.cfg, self.slots, self.max_len, self.device)

    def write_slot(self, caches: Caches, sub: Caches, slot: int) -> None:
        """Splice a batch-1 prefill result into ``slot``, every row whole."""
        write_cache_slot(caches, sub, slot)

    def reset_slot(self, caches: Caches, slot: int) -> None:
        reset_cache_slot(caches, slot)

    def check_fits(self, n_tokens: int) -> None:
        """Raise ``ValueError`` for a request that no row could hold."""
        limit = total_seq(self.cfg, self.max_len)
        if n_tokens > limit:
            raise ValueError(f"request needs {n_tokens} positions but a "
                             f"dense pool row holds {limit}")

    def alloc_pages(self, slot: int, n_tokens: int) -> None:
        limit = total_seq(self.cfg, self.max_len)
        if n_tokens > limit:
            raise PoolExhausted(
                f"dense pool row holds {limit} positions, request needs "
                f"{n_tokens}")

    def free(self, slot: int) -> None:
        return None

    def gather_args(self) -> Dict[str, torch.Tensor]:
        """No page table: the decode step runs on the dense rows."""
        return {}

    @property
    def pages_in_use(self) -> int:
        return 0

    @property
    def pages_hwm(self) -> int:
        return 0

    @property
    def total_pages(self) -> int:
        return 0

    def reset_stats(self) -> None:
        return None


class PagedCachePool:
    """Fixed-size pages in one preallocated pool + per-slot page tables,
    with the ``local`` layers' rings and the ``xdec`` layers' cross rows
    beside the pages.

    ``num_pages`` counts physical pages including the trash page; the
    default matches a dense pool of the same ``slots``/``max_len`` plus the
    trash page. The free list is a FIFO deque: pages allocate in ascending
    id order from a fresh pool and recycle in the order they were freed.

    ``faults`` optionally holds a
    :class:`repro_torch.serve.faults.FaultInjector`; the pool consults it on
    every real allocation attempt, so a seeded schedule can force
    exhaustion even while free pages exist.
    """

    kind = "paged"
    faults = None                      # Optional[FaultInjector]

    def __init__(self, cfg: ModelConfig, slots: int, max_len: int, *,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 device: Union[str, torch.device, None] = None):
        if not paged_supported(cfg):
            raise ValueError(
                f"{cfg.name}: sequential-state blocks "
                f"({SEQUENTIAL_STATE_BLOCKS}) cannot be paged; use "
                f"pool='dense'")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.slots = slots
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.max_len_total = total_seq(cfg, self.max_len)
        self.pages_per_slot = math.ceil(self.max_len_total / self.page_size)
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

    def check_fits(self, n_tokens: int) -> None:
        """Raise ``ValueError`` for a request that even the whole pool
        could not hold."""
        need = self.pages_for(n_tokens)
        if need > self.total_pages - 1:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.total_pages - 1} usable pages")

    def alloc_pages(self, slot: int, n_tokens: int) -> None:
        """Ensure ``slot`` owns pages covering positions [0, n_tokens)."""
        if n_tokens > self.max_len_total:
            raise PoolExhausted(
                f"slot page table holds {self.max_len_total} positions, "
                f"request needs {n_tokens}")
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

    def init(self) -> Caches:
        """Zeroed caches in the compute dtype on the pool's device:
        ``"k"``/``"v"`` (n_paged, N, ps, KV, D) pages of the
        full-attention layers and, per slot, the ``local`` layers'
        ``"ring_k"``/``"ring_v"`` (n_local, slots, ring, KV, D) and the
        ``xdec`` layers' ``"cross_k"``/``"cross_v"`` (n_xdec, slots,
        enc_seq, KV, D)."""
        cfg = self.cfg
        out = {}
        for pre, (t, n) in _stacks(cfg).items():
            for kv, (shape, dt, _) in layer_cache_spec(
                    cfg, t, self.slots, self.max_len_total).items():
                if t in _PAGED_BLOCKS:
                    shape = (self.num_pages, self.page_size, cfg.n_kv_heads,
                             cfg.head_dim_)
                out[pre + kv] = torch.zeros((n,) + shape, dtype=dt,
                                            device=self.device)
        return out

    def write_slot(self, caches: Caches, sub: Caches, slot: int) -> None:
        """Splice a batch-1 dense tree (:func:`init_caches` at ``max_len``,
        filled by a whole-prompt prefill) into ``slot`` in place: its full
        rows scatter through the slot's page row (positions past its pages
        land on the trash page), its rings and cross rows replace the
        slot's whole, a ring's zero tail included."""
        row = self.page_row(slot).long()
        pos = torch.arange(self.max_len_total, device=self.device)
        pages, offs = row[pos // self.page_size], pos % self.page_size
        for kv in ("k", "v"):
            if kv in caches:
                caches[kv][:, pages, offs] = sub[kv][:, 0]
        write_cache_slot(caches, sub, slot, self._slot_keys(caches))

    def reset_slot(self, caches: Caches, slot: int) -> None:
        """Zero the slot's cache state in place: its pages through its page
        row, in every layer, and for the row's unallocated entries the
        trash page (as the reference's scatter of a fresh cache does), and
        its rings and cross rows. Call before :meth:`free`, which sends the
        row to the trash page."""
        row = self.page_row(slot).long()
        for kv in ("k", "v"):
            if kv in caches:
                caches[kv][:, row] = 0
        reset_cache_slot(caches, slot, self._slot_keys(caches))

    @staticmethod
    def _slot_keys(caches: Caches) -> Tuple[str, ...]:
        """The entries held per slot beside the pages: every one but the
        paged ``"k"``/``"v"`` (rings and cross rows)."""
        return tuple(k for k in caches if k not in ("k", "v"))


def make_pool(cfg: ModelConfig, slots: int, max_len: int, *,
              kind: str = "paged", page_size: int = 16,
              num_pages: Optional[int] = None,
              device: Union[str, torch.device, None] = None
              ) -> Union[DenseCachePool, PagedCachePool]:
    """The reference's pool factory: ``kind`` ``"paged"`` (dense for
    sequential-state archs, which cannot be paged) or ``"dense"``."""
    if kind == "dense" or (kind == "paged" and not paged_supported(cfg)):
        return DenseCachePool(cfg, slots, max_len, device=device)
    if kind == "paged":
        return PagedCachePool(cfg, slots, max_len, page_size=page_size,
                              num_pages=num_pages, device=device)
    raise ValueError(f"unknown pool kind {kind!r}: expected 'paged' or "
                     f"'dense'")
