"""Config dataclasses: model architecture, where the butterfly goes, and
training.

Frozen and hashable, like the reference's. Only the fields the port's
serving and training paths read are kept; dtypes resolve to ``torch``
dtypes.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class ButterflyConfig:
    """Where to apply the paper's butterfly sandwich (§3.2).

    ``sites``: subset of {"lm_head", "mlp"}. ``k_factor`` multiplies the
    paper's ``k = log2(n)`` core size. ``seed`` feeds the per-site
    truncation-index derivation (:func:`repro_torch.models.common.
    site_butterfly_spec`).

    The execution fields (``backend``, ``block_b``, ``segment``,
    ``mesh_shape``) are the config layer of the
    :class:`~repro_torch.kernels.context.ExecutionContext` resolution
    order, lifted by ``ExecutionContext.from_butterfly_config``: an
    explicit per-call context or an ambient ``use_execution`` block
    overrides them field by field. ``backend`` is ``"auto" | "torch" |
    "cuda"``; ``segment`` the butterfly backward's checkpoint interval
    (``None``: ⌈√p⌉). ``block_b`` and ``mesh_shape`` construct, so that the
    reference's configs do, but a context that sets them is refused at
    resolution (ROADMAP items 7 and 6).
    """

    sites: Tuple[str, ...] = ("lm_head",)
    k_factor: float = 1.0
    seed: int = 0
    use_bias: bool = False
    backend: str = "auto"
    block_b: Optional[int] = None
    segment: Optional[int] = None
    mesh_shape: Optional[Tuple[int, ...]] = None


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    block_unit: Tuple[str, ...] = ("attn",)
    mlp_variant: str = "swiglu"    # swiglu | geglu | gelu_mlp
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    logit_softcap: float = 0.0
    butterfly: Optional[ButterflyConfig] = None
    # --- training: per-layer activation checkpointing, attention tiles ---
    remat: bool = True
    attn_block_q: int = 512        # blockwise attention tile sizes
    attn_block_kv: int = 1024
    blockwise_threshold: int = 8192  # use blockwise attention if S >= this

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """The reference's training knobs. ``grad_compression`` is ``""``,
    ``"topk"`` (keeping the ``grad_compression_ratio`` largest fraction)
    or ``"int8"``, with error feedback
    (:mod:`repro_torch.optim.compression`)."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    microbatches: int = 1          # gradient-accumulation factor
    seed: int = 0
    checkpoint_every: int = 200
    checkpoint_dir: str = ""
    keep_checkpoints: int = 3
    grad_compression: str = ""     # "" | "topk" | "int8"
    grad_compression_ratio: float = 0.01
    log_every: int = 10
