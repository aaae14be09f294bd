"""Config dataclasses: model architecture, shape cells, where the
butterfly goes, and training.

Frozen and hashable, like the reference's, field for field: every one of
the zoo's ten configs constructs here, and the port builds, serves and
trains each. ``seq_shard_activations`` and ``moe_token_chunk`` have no
single-device meaning and are kept as data, as
``ButterflyConfig.mesh_shape`` is. Dtypes resolve to ``torch`` dtypes.
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
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # --- attention ---
    sliding_window: int = 0        # 0 = full attention
    rope_theta: float = 10000.0
    # --- layer pattern: repeating unit of block types; n_layers =
    #     repeats * len(unit) + tail (tail = unit prefix) ---
    block_unit: Tuple[str, ...] = ("attn",)
    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2
    # --- hybrid (RG-LRU / Griffin) ---
    lru_width: int = 0
    conv_width: int = 4
    # --- enc-dec ---
    n_enc_layers: int = 0
    enc_seq: int = 0               # encoder (frontend) sequence length
    # --- frontend stubs (vlm/audio): precomputed embeddings ---
    frontend: str = ""             # "" | "vision" | "audio"
    frontend_tokens: int = 0
    # --- mlp ---
    mlp_variant: str = "swiglu"    # swiglu | geglu | gelu_mlp
    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    logit_softcap: float = 0.0
    tie_embeddings: bool = False
    # --- paper technique ---
    butterfly: Optional[ButterflyConfig] = None
    # --- training: per-layer activation checkpointing, attention tiles ---
    remat: bool = True
    attn_block_q: int = 512        # blockwise attention tile sizes
    attn_block_kv: int = 1024
    blockwise_threshold: int = 8192  # use blockwise attention if S >= this
    mlstm_chunk: int = 256
    moe_token_chunk: int = 8192    # the reference's EP dispatch bound
    seq_shard_activations: bool = True   # multi-device only: data here

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def unit_repeats(self) -> int:
        return self.n_layers // len(self.block_unit)

    @property
    def tail_layers(self) -> Tuple[str, ...]:
        return self.block_unit[: self.n_layers % len(self.block_unit)]

    @property
    def lru_width_(self) -> int:
        return self.lru_width or self.d_model

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (seq_len, global_batch) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}

#: archs with a sub-quadratic or bounded-window attention path may run the
#: 512k-context decode cell; pure full-attention archs skip it
LONG_CONTEXT_OK = ("recurrentgemma-2b", "xlstm-125m", "gemma3-27b")


def cell_applicable(model: ModelConfig, shape: ShapeConfig
                    ) -> Tuple[bool, str]:
    if shape.name == "long_500k" and model.name not in LONG_CONTEXT_OK:
        return False, "skip: pure full-attention arch at 512k context"
    return True, ""


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
