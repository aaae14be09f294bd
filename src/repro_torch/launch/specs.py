"""Abstract inputs and parameter accounting for the dry-run, on ``meta``
tensors: nothing is allocated for the full-size configs.

Counterpart of ``repro.launch.specs``. ``batch_specs``, ``decode_specs``
and ``abstract_model`` build meta tensors on the port's own modules;
``param_counts`` and ``model_flops`` keep the reference's formulas. The
reference's sharding trees (``batch_shardings``, ``cache_shardings``,
``param_shardings``, ``replicated``, ``_CACHE_AXES``) come with ROADMAP
queue 1, item 6c, beside ``kv_layout`` and a logical-axes table for the
port's leaves; the butterfly sites' row sharding (item 6a) needs none of
them.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.serve import cache as sc

META = torch.device("meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Training/prefill batch: a meta tensor for every model input."""
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": torch.empty(B, S, dtype=torch.int32, device=META)}
    if shape.kind == "train":
        out["targets"] = torch.empty(B, S, dtype=torch.int32, device=META)
        out["mask"] = torch.empty(B, S, dtype=torch.float32, device=META)
    if cfg.frontend == "vision":
        out["frontend_embeds"] = torch.empty(
            B, cfg.frontend_tokens, cfg.d_model, device=META)
    if cfg.n_enc_layers:
        out["frames"] = torch.empty(B, cfg.enc_seq, cfg.d_model,
                                    device=META)
    return out


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int
                ) -> Dict[str, torch.Tensor]:
    """The serving caches of ``batch`` rows of ``seq_len`` positions in the
    dense layout (:func:`repro_torch.serve.cache.init_caches`), on meta."""
    return sc.init_caches(cfg, batch, seq_len, device=META)


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> Tuple:
    """(token, caches, cur_pos) meta tensors for a serve step."""
    B, S = shape.global_batch, shape.seq_len
    token = torch.empty(B, dtype=torch.int32, device=META)
    cur_pos = torch.empty((), dtype=torch.int32, device=META)
    return token, cache_specs(cfg, B, S), cur_pos


@functools.lru_cache(maxsize=8)
def abstract_model(cfg: ModelConfig) -> lm.LM:
    """The port's ``LM`` of ``cfg`` with meta parameters: its modules and
    shapes, no weights drawn (the truncation indices are, from their seeded
    generators, on the CPU)."""
    with torch.device(META):
        return lm.LM(cfg)


def tensor_bytes(tensors) -> int:
    """Bytes of a dict (or iterable) of tensors."""
    if isinstance(tensors, dict):
        tensors = tensors.values()
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# Parameter accounting (for the roofline's model FLOPs)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def param_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(total, active) parameter counts; active discounts unrouted
    experts."""
    total = sum(p.numel() for p in abstract_model(cfg).parameters())
    active = total
    if cfg.n_experts and cfg.top_k:
        expert_params = (cfg.n_layers * cfg.n_experts * 3
                         * cfg.d_model * cfg.d_ff)
        active = total - expert_params \
            + cfg.n_layers * cfg.top_k * 3 * cfg.d_model * cfg.d_ff
    return total, active


def model_flops(cfg: ModelConfig, shape: ShapeConfig, n_devices: int = 1
                ) -> Tuple[float, int]:
    """(per-device model FLOPs, tokens): 6·N_active·D for training,
    2·N_active·D forward-only for prefill and decode. The embedding gather
    is not a matmul: its parameters are discounted (an untied head is one
    and stays counted)."""
    _, active = param_counts(cfg)
    matmul_params = active - cfg.vocab_size * cfg.d_model
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        factor = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        factor = 2.0
    else:                          # decode: one token per sequence
        tokens = shape.global_batch
        factor = 2.0
    return factor * matmul_params * tokens / n_devices, tokens
