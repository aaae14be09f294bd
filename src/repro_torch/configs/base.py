"""Config dataclasses: model architecture and where the butterfly goes.

Frozen and hashable, like the reference's. Only the fields the port's
serving path reads are kept; dtypes resolve to ``torch`` dtypes.
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
    """

    sites: Tuple[str, ...] = ("lm_head",)
    k_factor: float = 1.0
    seed: int = 0
    use_bias: bool = False


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

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)
