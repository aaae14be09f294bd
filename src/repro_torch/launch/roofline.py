"""The H100's roofline: the card's constants, the work counts of the port's
kernels, and the per-step report of the dry-run.

Counterpart of ``repro.launch.roofline``. The reference derives its terms
from an AOT-compiled XLA executable on a TPU pod; the port runs on one
H100 and derives them from an op tally over meta tensors
(:mod:`repro_torch.launch.op_analysis`), so the reference's HLO readers
(``shape_bytes``, ``parse_collectives``, ``cost_analysis_dict``) have no
counterpart here. Per step, per card:

    compute    = FLOPs / PEAK_FLOPS (dense bfloat16 on the tensor cores)
    memory     = bytes / HBM_BW
    collective = 0 on one card (collectives come with the multi-device path)

The card: NVIDIA H100 80GB HBM3 at a 700 W power limit, as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` names it; the rates
are its data sheet's (SXM). A card set below 700 W runs slower under load,
so every time held against these bounds stands beside the card's name and
limit.

Each kernel of the port has one work function giving ``(bytes, ops)`` for
one call at the given shapes and dtype: the bytes the call must move (each
input read once, each output written once) and the operations it performs
on this call's data (a sparse support or a mask counts what it keeps, not
the dense count). :func:`bound_ms` turns them into the least time the card
could take.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_BF16 = 989e12          # dense bfloat16 on the tensor cores, op/s
PEAK_FP32 = 67e12           # float32 on the CUDA cores, op/s
PEAK_TF32 = 495e12          # TF32 on the tensor cores, op/s
# a float32 route on the tensor cores in 3xTF32 (three TF32 products for
# each float32 one): the TF32 peak over three
PEAK_3XTF32 = PEAK_TF32 / 3
PEAK_OPS = {"bfloat16": PEAK_BF16, "float32": PEAK_FP32}
PEAK_FLOPS = PEAK_BF16      # the step terms' compute rate (bf16 models)
HBM_BW = 3.35e12            # bytes/s
HBM_BYTES = 80e9            # device memory
# the dynamic shared memory one block may opt in to (sm_90: 227 KB), where
# no device can be asked; the reference's VMEM budget takes this place
SMEM_OPTIN_BYTES = 227 * 1024

DTypeLike = Union[str, torch.dtype]


def dtype_name(dtype: DTypeLike) -> str:
    """``"float32"`` / ``"bfloat16"`` for a dtype or its name."""
    return str(dtype).replace("torch.", "")


def itemsize(dtype: DTypeLike) -> int:
    return getattr(torch, dtype_name(dtype)).itemsize


def smem_optin_bytes(device: Optional[int] = None) -> int:
    """The opt-in shared memory per block of CUDA device ``device`` (the
    current one by default), read from the device; ``SMEM_OPTIN_BYTES``
    without one."""
    if not torch.cuda.is_available():
        return SMEM_OPTIN_BYTES
    props = torch.cuda.get_device_properties(
        torch.cuda.current_device() if device is None else device)
    return int(getattr(props, "shared_memory_per_block_optin",
                       SMEM_OPTIN_BYTES))


def bound_ms(nbytes: float, ops: float, peak: float) -> Tuple[float, str]:
    """(the least ms for ``nbytes`` over HBM and ``ops`` at ``peak`` op/s,
    ``"bytes"`` or ``"operations"``: the larger term)."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------------------
# #1-2: the sandwich, forward and backward
# ---------------------------------------------------------------------------

def sandwich_ops(spec) -> Tuple[int, int]:
    """(forward, backward) operations per row of one sandwich site
    (:class:`repro_torch.core.layers.ButterflySpec`), counted on the support
    the function needs, not densely.

    Input side (stage s, stride 2^s, applied s-th): X[s] holds the nonzeros
    of stage s's input (x is n_in wide in n1), D[s] the positions there
    that reach the k1 selected outputs. Output side (stage p2-1-j applied
    j-th): V[j] holds the nonzeros of its input (from the k2 scattered
    values), G[j] the positions that reach the n_out live columns. The
    forward computes stage outputs on D and on V ∩ G. The backward
    recomputes the stage inputs it reads, takes each dual stage on the same
    sets (the cotangent of the output chain is needed on V, of the input
    chain it is nonzero on D) and forms a weight product, a multiply and an
    add into the sum over rows, wherever a nonzero cotangent meets a
    nonzero stage input. The core: 2·k1·k2 forward, 4·k1·k2 backward, and
    the scales."""

    def stage_ops(src, need, stride: int) -> int:
        """One stage (either direction) producing the elements ``need``
        from an input whose nonzeros are ``src`` (boolean masks): a
        multiply for each nonzero term, an add where an element has two."""
        partner = src[np.arange(src.size) ^ stride]
        return int((need & src).sum() + (need & partner).sum()
                   + (need & src & partner).sum())

    n1, n2 = spec.pad_in, spec.pad_out
    p1, p2 = int(math.log2(n1)), int(math.log2(n2))
    a1, a2 = np.arange(n1), np.arange(n2)
    X = [a1 < spec.n_in]
    for s in range(p1):
        X.append(X[-1] | X[-1][a1 ^ (1 << s)])
    D = [np.isin(a1, spec.idx_in)]
    for s in reversed(range(p1)):
        D.insert(0, D[0] | D[0][a1 ^ (1 << s)])
    st = [1 << (p2 - 1 - j) for j in range(p2)]
    V = [np.isin(a2, spec.idx_out)]
    for j in range(p2):
        V.append(V[-1] | V[-1][a2 ^ st[j]])
    G = [a2 < spec.n_out]
    for j in reversed(range(p2)):
        G.insert(0, G[0] | G[0][a2 ^ st[j]])
    k1, k2 = spec.k_in, spec.k_out
    in_fwd = sum(stage_ops(X[s], D[s + 1], 1 << s) for s in range(p1))
    out_fwd = [stage_ops(V[j], V[j + 1] & G[j + 1], st[j])
               for j in range(p2)]
    fwd = in_fwd + 2 * k1 * k2 + k1 + k2 + sum(out_fwd)
    live = D[0] & X[0]                           # dx on the n_in columns
    bwd = (in_fwd + 2 * k1 * k2 + k1 + k2 + sum(out_fwd[:-1])
           + 4 * k1 * k2 + k1 + k2)
    for j in range(p2):
        bwd += stage_ops(G[j + 1], V[j] & G[j], st[j])
        bwd += 2 * int((V[j] & G[j + 1]).sum()
                       + (V[j] & G[j + 1][a2 ^ st[j]]).sum())
    for s in range(p1):
        bwd += stage_ops(D[s + 1], live if s == 0 else D[s], 1 << s)
        bwd += 2 * int((D[s + 1] & X[s]).sum()
                       + (D[s + 1] & X[s][a1 ^ (1 << s)]).sum())
    return fwd, bwd


def _sandwich_weights(spec) -> int:
    """Floats of one site's weights: both butterflies and the core."""
    n1, n2 = spec.pad_in, spec.pad_out
    p1, p2 = int(math.log2(n1)), int(math.log2(n2))
    return 2 * p1 * n1 + 2 * p2 * n2 + spec.k_in * spec.k_out


def sandwich_fwd_work(spec, rows: int, dtype: DTypeLike) -> Tuple[int, int]:
    """(bytes, ops) of one sandwich forward call (kernel #1): activations in
    and out once, float32 weights once; :func:`sandwich_ops` per row."""
    item = itemsize(dtype)
    nbytes = (rows * (spec.n_in + spec.n_out) * item
              + 4 * (_sandwich_weights(spec) + spec.k_in + spec.k_out))
    return nbytes, rows * sandwich_ops(spec)[0]


def sandwich_bwd_work(spec, rows: int, dtype: DTypeLike) -> Tuple[int, int]:
    """(bytes, ops) of one sandwich backward call (kernel #2): x, g read and
    dx written once, float32 weights read and their gradients written once;
    per row the recompute and the VJP on the support they need
    (:func:`sandwich_ops`)."""
    item = itemsize(dtype)
    nbytes = (rows * (2 * spec.n_in + spec.n_out) * item
              + 4 * 2 * _sandwich_weights(spec)
              + 4 * (spec.k_in + spec.k_out))
    return nbytes, rows * sandwich_ops(spec)[1]


# ---------------------------------------------------------------------------
# #3: the paged decode
# ---------------------------------------------------------------------------

def paged_decode_work(batch: int, kv_heads: int, group: int, head_dim: int,
                      live: int, pages: int, dtype: DTypeLike
                      ) -> Tuple[int, int]:
    """(bytes, ops) of one paged decode call (kernel #3) over ``live``
    visible positions in all (the sum of ``cur_pos + 1`` over the batch):
    q read and the output written once, each live position's K and V row
    read once, the page table (``pages`` a slot) and ``cur_pos`` int32;
    4·D operations per query head and live position (q·k, p·v)."""
    item = itemsize(dtype)
    q = batch * kv_heads * group * head_dim
    nbytes = (2 * q * item + 2 * live * kv_heads * head_dim * item
              + batch * pages * 4 + batch * 4)
    return nbytes, 4 * live * kv_heads * group * head_dim


# ---------------------------------------------------------------------------
# #4-5: the butterfly, forward and backward
# ---------------------------------------------------------------------------

def butterfly_fwd_work(rows: int, n: int, dtype: DTypeLike
                       ) -> Tuple[int, int]:
    """(bytes, ops) of one butterfly forward call (kernel #4): the
    activations in and out once, float32 weights read once; 3 operations
    per element and stage."""
    p = int(math.log2(n))
    return (2 * rows * n * itemsize(dtype) + 4 * 2 * p * n,
            rows * 3 * n * p)


def butterfly_bwd_work(rows: int, n: int, dtype: DTypeLike,
                       need_dx: bool = False) -> Tuple[int, int]:
    """(bytes, ops) of one butterfly backward call (kernel #5): x and g read
    (and dx written) once, float32 weights read and dw written once; 3
    operations per element and stage application (the segmented schedule's
    :func:`repro_torch.kernels.butterfly.stage_applies`), 4 per element and
    stage for the two weight products."""
    from repro_torch.kernels.butterfly import stage_applies
    p = int(math.log2(n))
    nbytes = (2 + need_dx) * rows * n * itemsize(dtype) + 2 * 4 * 2 * p * n
    return nbytes, rows * (3 * n * stage_applies(p) + 4 * n * p)


# ---------------------------------------------------------------------------
# #6-8: flash attention, forward, dq, dkv
# ---------------------------------------------------------------------------

def flash_pairs(S: int, causal: bool, window: int) -> int:
    """Visible (query, key) pairs of one head under the mask."""
    q = np.arange(S)
    hi = q + 1 if causal else np.full(S, S)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(S, int)
    return int(np.maximum(0, hi - lo).sum())


def _flash(B: int, H: int, S: int, D: int, dtype: DTypeLike, causal: bool,
           window: int) -> Tuple[int, int, int]:
    """(bytes of one (B, H, S, D) array, of one float32 (B·H, S) row
    vector, visible pairs over all heads)."""
    return (B * H * S * D * itemsize(dtype), B * H * S * 4,
            B * H * flash_pairs(S, causal, window))


def flash_fwd_work(B: int, H: int, S: int, D: int, dtype: DTypeLike,
                   causal: bool = True, window: int = 0) -> Tuple[int, int]:
    """(bytes, ops) of one flash forward call (kernel #6): q, k, v read, o
    and lse written once; 4·D operations per visible pair."""
    arr, rows, pairs = _flash(B, H, S, D, dtype, causal, window)
    return 4 * arr + rows, 4 * D * pairs


def flash_dq_work(B: int, H: int, S: int, D: int, dtype: DTypeLike,
                  causal: bool = True, window: int = 0) -> Tuple[int, int]:
    """(bytes, ops) of one dq call (kernel #7): q, k, v, dO read, lse and Δ
    read, dq written; 6·D operations per visible pair."""
    arr, rows, pairs = _flash(B, H, S, D, dtype, causal, window)
    return 5 * arr + 2 * rows, 6 * D * pairs


def flash_dkv_work(B: int, H: int, S: int, D: int, dtype: DTypeLike,
                   causal: bool = True, window: int = 0) -> Tuple[int, int]:
    """(bytes, ops) of one dkv call (kernel #8): q, k, v, dO read, lse and Δ
    read, dk and dv written; 8·D operations per visible pair."""
    arr, rows, pairs = _flash(B, H, S, D, dtype, causal, window)
    return 6 * arr + 2 * rows, 8 * D * pairs


# ---------------------------------------------------------------------------
# The step report
# ---------------------------------------------------------------------------

@dataclass
class CollectiveStats:
    """Collective traffic of a step: none on one card."""

    counts: Dict[str, int] = field(default_factory=dict)
    bytes_by_op: Dict[str, int] = field(default_factory=dict)
    ici_bytes: int = 0
    dcn_bytes: int = 0

    @property
    def total_bytes(self) -> int:
        return self.ici_bytes + self.dcn_bytes


@dataclass
class RooflineReport:
    """The roofline terms of one (arch × shape) step on one H100, with the
    reference's keys. ``argument_bytes`` is what the step's arguments hold
    (params, Adam's moments, the batch, the caches); the temporaries of a
    run have no count without running, so ``temp_bytes`` stays 0 and
    ``hbm_fit`` judges the arguments alone."""

    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    collective: CollectiveStats = field(default_factory=CollectiveStats)
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    alias_bytes: int = 0
    model_flops: float = 0.0       # 6·N_active·D train, 2·N_active·D else
    params_total: int = 0
    params_active: int = 0
    tokens: int = 0

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """The model FLOPs' time over the bound: the share of the step that
        useful compute would take if every term overlapped."""
        b = self.bound_time
        return self.model_flops / PEAK_FLOPS / b if b > 0 else 0.0

    @property
    def flops_utilization(self) -> float:
        """Model FLOPs over tallied FLOPs: how much of the counted compute
        is useful (remat, masked work and elementwise work lower it)."""
        return (self.model_flops / self.flops_per_device
                if self.flops_per_device else 0.0)

    @property
    def hbm_bytes(self) -> int:
        return (self.argument_bytes + self.output_bytes + self.temp_bytes
                - self.alias_bytes)

    @property
    def hbm_fit(self) -> bool:
        return self.hbm_bytes <= HBM_BYTES

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_devices": self.n_devices,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_ici_bytes": self.collective.ici_bytes,
            "collective_dcn_bytes": self.collective.dcn_bytes,
            "collective_counts": self.collective.counts,
            "collective_bytes_by_op": self.collective.bytes_by_op,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "alias_bytes": self.alias_bytes,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "params_total": self.params_total,
            "params_active": self.params_active,
            "tokens": self.tokens,
            "flops_utilization": self.flops_utilization,
            "roofline_fraction": self.roofline_fraction,
            "hbm_fit": self.hbm_fit,
        }
