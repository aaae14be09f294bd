"""The Hopper tile rule of the port's kernels.

Counterpart of ``repro.kernels.tuning``. The reference picks a batch tile
``block_b`` and a checkpoint ``segment`` for its Pallas kernels from a
model of the TPU's VMEM; on the H100 the tiles are the CUDA kernels' own,
and the budget they answer to is the shared memory one block may opt in to
(``repro_torch.launch.roofline.smem_optin_bytes``: 227 KB on an H100, read
from the device where there is one). This module is where every tile
choice of the butterfly, sandwich and flash kernels is made and recorded,
one :class:`KernelChoice` per ``(kernel, n, dtype, mode)``:

* ``block_b`` — the rows a block owns. Where a kernel's tile is a launch
  parameter (the butterfly backward's tile rows, the plan of
  ``csrc/butterfly_bwd.cu``) an override is honoured: a multiple of the
  kernel's row unit whose buffers fit the opt-in shared memory. Where the
  tile is compiled in (the butterfly forward's rows a block, the sandwich
  row kernels' 64 rows forward and 32 backward) only that value is taken.
  The flash kernels take no ``block_b`` (the reference's applies to the
  butterfly and sandwich kernels alone); their tiles are recorded.
* ``segment`` — the butterfly backward's checkpoint interval, ⌈√p⌉ alone:
  the kernel's register schedule is compiled for it.
* the sandwich forward's column groups (:func:`sandwich_groups`), the
  butterfly backward's blocks and tile rows (:func:`butterfly_bwd_plan`)
  and the flash backward's owned rows (:func:`flash_blocks`), which depend
  on the call's rows or on the built library.
* ``smem_bytes`` — the modeled shared memory of one block at the choice,
  a mirror of the kernels' own plans, against ``smem_limit``.
* ``est_us_per_row`` — the roofline bound of one row
  (:mod:`repro_torch.launch.roofline`'s work counts).

By default the rule reproduces the kernels' launches as they were before
it existed: it is a port of the reference's module, not a retune.

Overrides follow the reference's order: an explicit value (a context's
``block_b``/``segment``, from a call, an ambient ``use_execution`` block
or a config, folded by :func:`repro_torch.kernels.context.
resolve_execution`), then ``REPRO_TUNE_BLOCK_B`` / ``REPRO_TUNE_SEGMENT``,
then the rule. An override is honoured by the launch or refused with
``ValueError`` before any launch, naming the values the kernel takes; it is
never ignored. The reference's ``REPRO_TUNE_BLOCK_Q`` and
``REPRO_TUNE_VMEM_BUDGET`` are TPU knobs (a Pallas block, a VMEM budget)
and are not read: the flash kernels' tiles are their own, and the budget is
the card's.

On the CPU the plain twins run and nothing is queried: overrides are still
checked, and no choice is recorded (:func:`describe` then reads "no kernel
tuning queried").
"""

from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.launch import roofline as rl

__all__ = [
    "KernelChoice",
    "butterfly_bwd_plan",
    "cache_entries",
    "choice",
    "choices",
    "clear_choices",
    "default_segment",
    "describe",
    "flash_blocks",
    "launch_block_b",
    "resolve_block_b",
    "resolve_segment",
    "row_slots",
    "sandwich_groups",
    "smem_budget",
    "tune",
]

KERNELS = ("butterfly", "sandwich", "flash")
MODES = ("fwd", "bwd")

# -- the kernels' compiled constants (csrc/), mirrored ------------------------

BFLY_FWD_WARPS = 8            # butterfly.cu: warps a block, n <= 1024
BFLY_BWD_THREADS = 512        # butterfly_bwd.cu: threads a block
BFLY_SMEM_MAX = 227 * 1024    # butterfly_bwd.cu kSmemMax
SANDWICH_ROWS = {"fwd": 64, "bwd": 32}  # sandwich.cu / sandwich_bwd.cu kBM
SANDWICH_SMEM_MAX = 232448    # sandwich*.cu kMaxSmem
FLASH_TILE = 64               # flash_common.cuh kTileRows


# ---------------------------------------------------------------------------
# The choice record
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KernelChoice:
    """One tile choice (and what it costs)."""

    kernel: str
    n: int
    dtype: str
    mode: str                 # "fwd" | "bwd"
    block_b: int              # rows a block owns
    segment: int              # the backward's checkpoint interval (1 fwd)
    takes: Tuple[int, ...]    # the block_b values the kernel takes
    smem_bytes: int           # modeled shared memory a block, at block_b
    smem_limit: int           # the opt-in shared memory a block may use
    est_us_per_row: float     # roofline bound per row
    block_q: int = 0          # flash: query rows a block owns
    block_kv: int = 0         # flash: key rows a block owns (backward)
    tiles_in_device_memory: bool = False   # butterfly backward, n >= 16384

    def summary(self) -> str:
        extra = ""
        if self.kernel == "flash":
            extra = f" block_q={self.block_q} block_kv={self.block_kv}"
        elif self.kernel == "sandwich" and self.mode == "fwd":
            extra = " groups=by rows"
        elif self.kernel == "butterfly" and self.mode == "bwd":
            extra = " blocks=by rows"
        return (f"{self.kernel}/{self.mode} n={self.n} {self.dtype}: "
                f"block_b={self.block_b} segment={self.segment}{extra} "
                f"smem={self.smem_bytes / 1024:.1f}KB of "
                f"{self.smem_limit / 1024:.0f}KB "
                f"roofline={self.est_us_per_row:.4f}us/row")


def smem_budget() -> int:
    """The shared memory one block may opt in to on this process's card
    (the constant without one): the budget every modeled footprint answers
    to, in the reference's VMEM budget's place."""
    return _smem_budget_cached(torch.cuda.is_available())


@functools.lru_cache(maxsize=None)
def _smem_budget_cached(has_card: bool) -> int:
    return rl.smem_optin_bytes() if has_card else rl.SMEM_OPTIN_BYTES


def default_segment(stages: int) -> int:
    """⌈√p⌉, the reference's default checkpoint interval, and the one the
    butterfly backward kernel's register schedule takes."""
    if stages <= 1:
        return 1
    return math.isqrt(stages - 1) + 1


def _round16(v: int) -> int:
    return (v + 15) & ~15


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _dtype(dtype) -> str:
    name = rl.dtype_name(dtype)
    if name not in ("float32", "bfloat16"):
        raise TypeError(f"the kernels take float32 or bfloat16, got {dtype}")
    return name


# ---------------------------------------------------------------------------
# Shared-memory models (mirrors of the kernels' plans)
# ---------------------------------------------------------------------------

def _bfly_fwd_rows(n: int) -> int:
    """Rows a block of the butterfly forward owns (``Narrow<P>::ROWS`` ×
    warps for n <= 1024, ``Wide<P>::R`` above)."""
    p = n.bit_length() - 1
    if p <= 10:
        sub = 32 >> p if p < 5 else 1
        return 2 * sub * BFLY_FWD_WARPS
    return 2 if p <= 14 else 1


def _bfly_fwd_smem(n: int) -> int:
    p = n.bit_length() - 1
    return 8 * p * n if p <= 10 else 4 * _bfly_fwd_rows(n) * n


@dataclass(frozen=True)
class _BwdGeometry:
    """``Bwd<P>`` of ``csrc/butterfly_bwd.cu`` for one (n, dtype)."""

    n: int
    p: int
    unit: int                 # tiles are multiples of it
    ld: int                   # padded row (floats)
    bufs_smem: int            # row buffers of a tile in shared memory
    bufs_global: int          # ... in device memory
    stash: int                # bytes of the row slots' sums
    slots: int                # rows side by side (row slots)

    @property
    def max_tile(self) -> int:
        """The largest tile whose buffers fit in shared memory (0: none,
        the tile lives in device memory)."""
        row = 4 * self.bufs_smem * self.ld
        return BFLY_SMEM_MAX // (row * self.unit) * self.unit

    @property
    def in_global(self) -> bool:
        return self.max_tile < self.unit

    def smem(self, tile: int) -> int:
        b = 0 if self.in_global else 4 * self.bufs_smem * self.ld * tile
        return max(b, self.stash)


@functools.lru_cache(maxsize=None)
def _bwd_geometry(n: int, dtype: str) -> _BwdGeometry:
    p = n.bit_length() - 1
    seg = default_segment(p)
    nck = -(-p // seg)
    tpr = n // 2
    reg = tpr <= BFLY_BWD_THREADS
    rs = BFLY_BWD_THREADS // tpr if reg else 1
    unit = rs * (2 if reg else 1)
    ld = n + n // 8 if n >= 32 else n
    double = (dtype == "float32" and p >= 2
              and 4 * (nck + 3) * ld * unit <= BFLY_SMEM_MAX)
    stash = 4 * rs * 2 * p * n if reg and rs > 1 else 0
    return _BwdGeometry(n=n, p=p, unit=unit, ld=ld,
                        bufs_smem=nck + 1 + (2 if double else 0),
                        bufs_global=nck + 1, stash=stash, slots=rs)


def row_slots(n: int) -> int:
    """Rows the butterfly backward's block works side by side, each slot
    with its own ``dw`` sums (``BFLY_BWD_THREADS`` threads of 2 elements a
    row)."""
    return max(1, 2 * BFLY_BWD_THREADS // n)


def _sandwich_fwd_smem(k1: int, k2: int, n1: int, dtype: str) -> int:
    """``row_plan<T>(...).total`` of ``csrc/sandwich.cu``: the row kernel's
    shared memory."""
    f32 = dtype == "float32"
    es = 4 if f32 else 2
    kp1, kp2 = _up(k1, 16), _up(k2, 16)
    bm, kc = SANDWICH_ROWS["fwd"], 64
    a_stage = _round16((bm + kp1) * (kc + 4) * 4) if f32 else 0
    rb = 16384 // n1
    chain_rb = 1 if rb < 1 else min(rb, bm)
    tab_pairs = min(n1, 4096)
    wtab = not f32 and 32 <= n1 <= 2048
    fo_ld = 128 + (4 if f32 else 8)
    c_stage = _round16((1 if f32 else 2) * kp2 * fo_ld * es)
    z_ld = kp2 if f32 else kp2 + 8
    stg = 0 if f32 else _round16(bm * fo_ld * es)
    h1_off = _round16(k1 * k2 * 4)
    z_off = h1_off + _round16(bm * (kp1 + 1) * 4)
    pat_off = z_off + _round16(bm * z_ld * es)
    tab_off = pat_off + (0 if f32 else _round16(4 * (64 + 15 * (2 * 64 + 3))))
    wtab_off = tab_off + (0 if f32 else _round16(10 * tab_pairs))
    pipe_off = wtab_off + (5 * n1 * 4 if wtab else 0)
    a = 4 * a_stage if f32 else _round16(chain_rb * (n1 + 4) * 4)
    total = pipe_off + max(a, 4 * c_stage + stg)
    if total > SANDWICH_SMEM_MAX and not f32:
        cut = (total - SANDWICH_SMEM_MAX + 15) // 10
        tab_pairs = (tab_pairs - cut) & ~7 if tab_pairs > cut else 0
        total -= wtab_off - (tab_off + _round16(10 * tab_pairs))
    return total


def _sandwich_bwd_smem(k1: int, k2: int, dtype: str) -> int:
    """``row_plan<T, R>(...).total`` of ``csrc/sandwich_bwd.cu`` at the
    ring it launches (4 deep where that fits, else 2): the row kernel's
    shared memory, the largest of the backward's."""
    f32 = dtype == "float32"
    es = 4 if f32 else 2
    kp1, kp2 = _up(k1, 16), _up(k2, 16)
    kp, bm = max(kp1, kp2), SANDWICH_ROWS["bwd"]
    ld = 128 + (4 if f32 else 8)
    fa_off = _round16(bm * ld * es)
    slot = fa_off + (_round16(kp * ld * 4) if f32
                     else 2 * _round16(kp * ld * 2))
    dslot = (_round16(kp1 * ld * 4) if f32
             else 2 * _round16(kp1 * ld * 2))
    h1_off = _round16(k1 * k2 * 4)
    z_off = h1_off + _round16(bm * (kp1 + 1) * 4)
    dh2_off = z_off + _round16(bm * (kp2 + 1) * 4)
    du_off = dh2_off + _round16(bm * (kp2 + 1) * 4)
    duh_off = du_off + _round16(bm * (kp1 + 1) * 4)
    pipe_off = duh_off + (0 if f32 else _round16(bm * (kp1 + 8) * 2))
    units = 2 * (kp // 16)
    red = (bm * kp * 4 * (256 // (2 * kp)) if f32
           else bm * kp * 4 * (1 if units >= 8 else 8 // units))
    for ring in (4, 2):
        total = pipe_off + max(ring * slot, ring * dslot, red)
        if total <= SANDWICH_SMEM_MAX:
            break
    return total


def _flash_own(D: int, dtype: str, dq: bool) -> int:
    """``BwdSplit<...>::kOwn`` of ``csrc/flash_common.cuh``."""
    dmax = 64 if D <= 64 else 128 if D <= 128 else 256
    split = 2 if dmax > 128 or (dtype == "float32" and not dq
                                and dmax > 64) else 1
    return FLASH_TILE // split


def _flash_smem(D: int, dtype: str, mode: str) -> int:
    """The flash kernels' ``smem_bytes(D)``; the backward's larger of dq
    and dkv."""
    bf16 = dtype == "bfloat16"
    item = 2 if bf16 else 4
    dmax = 64 if D <= 64 else 128 if D <= 128 else 256
    stages = 2 if bf16 or dmax <= 128 else 1
    rs = _up(D, 16) + 8 if bf16 else D + 4
    if mode == "fwd":
        return item * (FLASH_TILE + stages * 2 * FLASH_TILE) * rs
    out = 0
    for dq in (True, False):
        stage = item * 2 * FLASH_TILE * rs + (0 if dq else 2 * FLASH_TILE * 4)
        own = _flash_own(D, dtype, dq)
        out = max(out, item * 2 * own * rs + stages * stage)
    return out


# ---------------------------------------------------------------------------
# The rule
# ---------------------------------------------------------------------------

def _us(work: Tuple[int, int], peak: float) -> float:
    return rl.bound_ms(*work, peak)[0] * 1e3


@functools.lru_cache(maxsize=None)
def _rule(kernel: str, n: int, dtype: str, mode: str, k1: int, k2: int,
          n1: int, budget: int) -> KernelChoice:
    """The choice for one (kernel, n, dtype, mode) cell; ``k1``, ``k2``,
    ``n1`` shape the sandwich's footprint (0 for the other kernels)."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown tunable kernel {kernel!r}; expected one "
                         f"of {KERNELS}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    p = max(1, n.bit_length() - 1)
    kw = dict(kernel=kernel, n=n, dtype=dtype, mode=mode, smem_limit=budget)
    if kernel == "butterfly":
        if mode == "fwd":
            b = _bfly_fwd_rows(n)
            return KernelChoice(
                block_b=b, segment=1, takes=(b,), smem_bytes=_bfly_fwd_smem(n),
                est_us_per_row=_us(rl.butterfly_fwd_work(1, n, dtype),
                                   rl.PEAK_FP32), **kw)
        geo = _bwd_geometry(n, dtype)
        if geo.in_global:
            # one row a tile, in device memory: the plan's only tile
            takes, b = (geo.unit,), geo.unit
        else:
            takes = tuple(range(geo.unit, geo.max_tile + 1, geo.unit))
            b = geo.max_tile
        return KernelChoice(
            block_b=b, segment=default_segment(p), takes=takes,
            smem_bytes=geo.smem(b), tiles_in_device_memory=geo.in_global,
            est_us_per_row=_us(rl.butterfly_bwd_work(1, n, dtype),
                               rl.PEAK_FP32), **kw)
    if kernel == "sandwich":
        # without the call's widths, the paper's k = log2 n at n1 = n
        n1 = n1 or n
        k1, k2 = k1 or p, k2 or p
        b = SANDWICH_ROWS[mode]
        smem = (_sandwich_fwd_smem(k1, k2, n1, dtype) if mode == "fwd"
                else _sandwich_bwd_smem(k1, k2, dtype))
        # per row on a dense support: both stage chains, the core
        work = (rl.itemsize(dtype) * 2 * n,
                3 * n * p * 2 + 2 * k1 * k2)
        if mode == "bwd":
            work = (work[0] * 3 // 2, work[1] * 3)
        return KernelChoice(block_b=b, segment=1, takes=(b,),
                            smem_bytes=smem,
                            est_us_per_row=_us(work, rl.PEAK_FP32), **kw)
    if mode == "fwd":
        bq = bkv = FLASH_TILE
        work = rl.flash_fwd_work(1, 1, FLASH_TILE, n, dtype, causal=False)
    else:
        bq, bkv = _flash_own(n, dtype, True), _flash_own(n, dtype, False)
        dq = rl.flash_dq_work(1, 1, FLASH_TILE, n, dtype, causal=False)
        dkv = rl.flash_dkv_work(1, 1, FLASH_TILE, n, dtype, causal=False)
        work = (dq[0] + dkv[0], dq[1] + dkv[1])
    peak = rl.PEAK_BF16 if dtype == "bfloat16" else rl.PEAK_3XTF32
    return KernelChoice(block_b=bq, segment=1, takes=(), block_q=bq,
                        block_kv=bkv, smem_bytes=_flash_smem(n, dtype, mode),
                        est_us_per_row=_us(work, peak) / FLASH_TILE, **kw)


def _key(choice: KernelChoice) -> str:
    return f"{choice.kernel}/{choice.mode}/n{choice.n}/{choice.dtype}"


# every choice a launch asked for this process, by key (the reference keeps
# the same registry for TrainResult and the benchmarks)
_CHOICES: Dict[str, KernelChoice] = {}
# tune()'s own cache, by its arguments as a launch passes them: a launch
# asks again on every call, eagerly, so a repeat is one dictionary lookup
_TUNED: Dict[tuple, Tuple[str, KernelChoice]] = {}


def choice(kernel: str, n: int, dtype, mode: str = "fwd", *, k1: int = 0,
           k2: int = 0, n1: int = 0) -> KernelChoice:
    """The rule's choice for one cell, without recording it (what a check
    on the CPU route reads)."""
    return _rule(kernel, int(n), _dtype(dtype), mode, int(k1), int(k2),
                 int(n1), smem_budget())


def tune(kernel: str, n: int, dtype, mode: str = "fwd", *, k1: int = 0,
         k2: int = 0, n1: int = 0) -> KernelChoice:
    """The rule's choice for one cell, recorded in :func:`cache_entries`:
    what a launch on the card asks. The sandwich's ``n`` is ``max(n1,
    n2)``, as the reference's; its footprint also reads ``k1``, ``k2`` and
    ``n1``. The flash kernels' ``n`` is the head dim."""
    args = (kernel, n, dtype, mode, k1, k2, n1)
    hit = _TUNED.get(args)
    if hit is None:
        c = choice(kernel, n, dtype, mode, k1=k1, k2=k2, n1=n1)
        hit = _TUNED[args] = (_key(c), c)
    _CHOICES[hit[0]] = hit[1]
    return hit[1]


def choices() -> Dict[str, KernelChoice]:
    """Every choice a launch asked for so far, by key."""
    return dict(_CHOICES)


def cache_entries() -> Dict[str, str]:
    """Every choice a launch asked for so far (key -> one-line summary)."""
    return {k: c.summary() for k, c in _CHOICES.items()}


def describe() -> str:
    """One summary per choice this process, sorted, joined by ``; ``."""
    return ("; ".join(sorted(c.summary() for c in _CHOICES.values()))
            or "no kernel tuning queried")


def clear_choices() -> None:
    """Forget the recorded choices (tests)."""
    _CHOICES.clear()


# ---------------------------------------------------------------------------
# Overrides
# ---------------------------------------------------------------------------

def _env_int(name: str) -> Optional[int]:
    env = os.environ.get(name, "").strip()
    return int(env) if env else None


def resolve_block_b(kernel: str, n: int, dtype, mode: str,
                    override: Optional[int] = None, *, k1: int = 0,
                    k2: int = 0, n1: int = 0) -> int:
    """The rows a block owns: ``override`` (the resolved context's
    ``block_b``) > ``REPRO_TUNE_BLOCK_B`` > the rule. A value the kernel
    does not take raises ``ValueError`` naming those it takes."""
    c = choice(kernel, n, dtype, mode, k1=k1, k2=k2, n1=n1)
    b = override if override is not None else _env_int("REPRO_TUNE_BLOCK_B")
    if b is None:
        return c.block_b
    b = int(b)
    if kernel == "flash":
        raise ValueError(
            f"block_b={b}: the flash kernels take no block_b (their tiles "
            f"are their own: {c.block_q} query and {c.block_kv} key rows a "
            f"block at D={n} {c.dtype}); the tile rule of ROADMAP item 7, "
            f"kernels/tuning.py")
    if b not in c.takes:
        takes = (f"{c.takes[0]}" if len(c.takes) == 1 else
                 f"multiples of {c.takes[0]} up to {c.takes[-1]}")
        raise ValueError(
            f"block_b={b}: the {kernel} {mode} kernel at n={n} {c.dtype} "
            f"takes block_b {takes} (the tile rule of ROADMAP item 7, "
            f"kernels/tuning.py)")
    return b


def launch_block_b(override: Optional[int], kernel: str, n: int, dtype,
                   modes: Tuple[str, ...], *, k1: int = 0, k2: int = 0,
                   n1: int = 0) -> Optional[int]:
    """What a call's launches take from its context's ``block_b``
    (``override``) or ``REPRO_TUNE_BLOCK_B``: ``None`` when neither names
    one (the rule's own tiles), else the value, checked against the kernel
    of each of ``modes`` before any launch (:func:`resolve_block_b`). A
    dtype the kernels do not take is left to their own checks."""
    if override is None and not os.environ.get("REPRO_TUNE_BLOCK_B"):
        return None
    if rl.dtype_name(dtype) not in ("float32", "bfloat16"):
        return None
    for mode in modes:
        b = resolve_block_b(kernel, n, dtype, mode, override, k1=k1, k2=k2,
                            n1=n1)
    return b


def resolve_segment(stages: int, override: Optional[int] = None) -> int:
    """The butterfly backward's checkpoint interval: ``override`` (the
    resolved context's ``segment``) > ``REPRO_TUNE_SEGMENT`` > ⌈√p⌉. The
    kernel's register schedule is compiled for ⌈√p⌉, and the plain route
    follows it: another value raises ``ValueError``."""
    seg = override if override is not None else _env_int(
        "REPRO_TUNE_SEGMENT")
    want = default_segment(stages)
    if seg is not None and int(seg) != want:
        raise ValueError(
            f"segment={seg}: the butterfly backward runs segment ⌈√p⌉ = "
            f"{want} for p = {stages}, the one its register schedule takes "
            f"(the tile rule of ROADMAP item 7, kernels/tuning.py)")
    return want


# ---------------------------------------------------------------------------
# Launch values that depend on the call
# ---------------------------------------------------------------------------

def sandwich_groups(rows: int, chunks: int, sms: int) -> int:
    """Column groups of the sandwich forward's row kernel (row tiles of 64
    rows times groups of 128-wide output chunks), about one block per SM
    where the chunks allow. Every group of a row tile runs its input side
    again: narrow outputs (the MLP's), where that side takes most of a
    block's time, round the count down to one group per tile once there
    are about as many tiles as SMs; wide ones (the head's), bound by their
    stores, round up, which puts two blocks on an SM."""
    tiles = -(-rows // SANDWICH_ROWS["fwd"])
    if chunks >= 64:
        return min(chunks, -(-sms // tiles))
    return min(chunks, max(1, (sms + tiles // 2) // tiles))


@functools.lru_cache(maxsize=None)
def _bwd_plan(rows: int, n: int, transpose: bool, dtype: int,
              device: int) -> tuple:
    """The butterfly backward's launch plan for one shape on one device,
    asked of the built library once: (blocks, partial floats, tile-workspace
    floats, tile rows)."""
    import ctypes

    from repro_torch.kernels.butterfly import _bwd_lib
    sizes = (ctypes.c_longlong * 4)()
    with torch.cuda.device(device):
        err = _bwd_lib().butterfly_bwd_plan(
            rows, n, default_segment(n.bit_length() - 1), int(transpose),
            dtype, sizes)
    if err != 0:
        raise RuntimeError(f"butterfly_bwd_plan failed with cudaError {err} "
                           f"(rows={rows}, n={n})")
    return tuple(int(v) for v in sizes)


def butterfly_bwd_plan(rows: int, n: int, transpose: bool, dtype,
                       device: int, block_b: Optional[int] = None) -> tuple:
    """The butterfly backward's launch: (blocks, partial floats,
    tile-workspace floats, tile rows). The library's plan, with its tile
    rows replaced by an honoured ``block_b`` (:func:`resolve_block_b`): the
    blocks, and so the order ``dw`` is summed in, stay the plan's, so the
    outputs keep their bits."""
    name = _dtype(dtype)
    blocks, part, tiles, tile = _bwd_plan(
        rows, n, bool(transpose), 0 if name == "float32" else 1, device)
    if block_b is not None and block_b != tile:
        if tiles:
            tiles = tiles // tile * block_b
        tile = block_b
    return blocks, part, tiles, tile


def flash_blocks(head_dim: int, dtype, mode: str = "fwd"
                 ) -> Tuple[int, int]:
    """(block_q, block_kv): the rows a block of the flash kernels owns at
    ``head_dim`` in ``dtype`` — 64 and 64 forward; backward, the dq
    kernel's query rows and the dkv kernel's key rows (64, or 32 where one
    warp's accumulators would not fit: above D = 128, and for float32's
    dkv above 64)."""
    c = choice("flash", head_dim, dtype, mode)
    return c.block_q, c.block_kv
