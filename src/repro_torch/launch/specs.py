"""Abstract inputs, sharding trees and parameter accounting for the
dry-run, on ``meta`` tensors: nothing is allocated for the full-size
configs.

Counterpart of ``repro.launch.specs``. ``batch_specs``, ``decode_specs``
and ``abstract_model`` build meta tensors on the port's own modules;
``param_counts`` and ``model_flops`` keep the reference's formulas.

The sharding half: :func:`batch_shardings`, :func:`cache_shardings`,
:func:`param_shardings` and :func:`replicated` return
:class:`~repro_torch.runtime.sharding.PartitionSpec` trees over the port's
own leaves (a batch dict, the flat cache dict, the model's parameter
names), resolved by the reference's rules
(:func:`~repro_torch.runtime.sharding.logical_to_pspec`). The port has no
``NamedSharding``: a mesh and a spec stand for one, and
:func:`sharded_bytes` is a leaf's bytes on one card under them. The
logical axes come from one table each: :data:`PARAM_AXES` for the
parameters (keyed by the reference leaf that holds a port parameter,
:func:`repro_torch.convert.reference_key`, so that the reference's
``ParamSpec`` axes are not guessed a second time; the tests hold every
entry against them), :data:`_CACHE_AXES` and
:func:`repro_torch.models.attention.kv_layout` for the caches. The port
executes only the butterfly sites' rows over ``pod``/``data``
(:mod:`repro_torch.runtime.butterfly_sharding`); every other axis here is
launch accounting.
"""

from __future__ import annotations

import functools
import math
import re
from typing import Dict, Sequence, Tuple

import torch

from repro_torch import convert
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.models.attention import kv_layout
from repro_torch.runtime import sharding as sh
from repro_torch.runtime.sharding import PartitionSpec
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
# Sharding trees
# ---------------------------------------------------------------------------

_STAGES = ("stages", "butterfly_pair", "butterfly_n")
#: a butterfly site's leaves (``ffn.up``, ``ffn.gate``, ``ffn.down``,
#: ``head``): weights replicated by the rules, rows sharded at run time
_SITE_AXES = {"b_in": _STAGES, "b_out": _STAGES,
              "core": ("butterfly_core_out", "butterfly_core_in"),
              "bias": ("butterfly_bias",)}
_SITES = ("ffn.up", "ffn.gate", "ffn.down", "head")
_ATTN = {"wq": ("embed", "heads", "head_dim"),
         "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"),
         "wo": ("heads", "head_dim", "embed")}

#: the logical axes of every reference leaf holding a port parameter, one
#: layer's (the stacked repeat axis of a ``unit`` leaf is not in them):
#: keyed by the reference key with its ``unit[i].``/``tail[j].``/
#: ``enc_unit[0].`` prefix dropped; a site's leaves are in
#: :data:`_SITE_AXES`
PARAM_AXES: Dict[str, Tuple] = {
    "embed.table": ("vocab", "embed"),
    "final_norm": (None,), "enc_norm": (None,),
    "frontend_proj": ("embed", None),
    "head.w": ("embed", "vocab"),
    "norm1": (None,), "norm2": (None,), "norm_x": (None,),
    **{f"attn.{k}": v for k, v in _ATTN.items()},
    **{f"xattn.{k}": v for k, v in _ATTN.items()},
    "ffn.up.w": ("embed", "mlp"), "ffn.gate.w": ("embed", "mlp"),
    "ffn.down.w": ("mlp", "embed"),
    "ffn.router": ("embed", None),
    "ffn.w_gate": ("experts", "embed", "expert_mlp"),
    "ffn.w_up": ("experts", "embed", "expert_mlp"),
    "ffn.w_down": ("experts", "expert_mlp", "embed"),
    "rec.b_a": (None,), "rec.b_x": (None,), "rec.lam": (None,),
    "rec.conv": (None, "rnn_state"),
    "rec.w_a": ("rnn_state", None), "rec.w_x": ("rnn_state", None),
    "rec.w_in": ("embed", "rnn_state"),
    "rec.w_gate_branch": ("embed", "rnn_state"),
    "rec.w_out": ("rnn_state", "embed"),
    "mlstm.b_fgate": (None,), "mlstm.b_igate": (None,),
    "mlstm.conv": (None, "mlp"), "mlstm.headnorm": (None,),
    "mlstm.w_up": ("embed", "mlp"), "mlstm.w_down": ("mlp", "embed"),
    "mlstm.w_fgate": ("mlp", None), "mlstm.w_igate": ("mlp", None),
    "mlstm.wq": ("mlp", None), "mlstm.wk": ("mlp", None),
    "mlstm.wv": ("mlp", None),
    "slstm.b_zifo": (None,), "slstm.groupnorm": (None,),
    "slstm.r_zifo": (None, None, None),
    "slstm.w_zifo": ("embed", "mlp"), "slstm.ffn_up": ("embed", "mlp"),
    "slstm.ffn_gate": ("embed", "mlp"), "slstm.ffn_down": ("mlp", "embed"),
}

_LAYER_PREFIX = re.compile(r"^(unit|tail|enc_unit)\[\d+\]\.")


def param_axes(name: str, cfg: ModelConfig) -> Tuple:
    """The logical axes of the port parameter ``name`` of a model of
    ``cfg``: its reference leaf's (:data:`PARAM_AXES`); ``KeyError`` for a
    leaf the table does not know."""
    path = _LAYER_PREFIX.sub("", convert.reference_key(name, cfg))
    site, _, leaf = path.rpartition(".")
    if site in _SITES and leaf in _SITE_AXES:
        return _SITE_AXES[leaf]
    if path not in PARAM_AXES:
        raise KeyError(f"no logical axes for {name} (reference leaf "
                       f"{path!r}); add it to PARAM_AXES")
    return PARAM_AXES[path]


def param_shardings(cfg: ModelConfig, mesh, rules=sh.DEFAULT_RULES
                    ) -> Dict[str, PartitionSpec]:
    """``{parameter name: PartitionSpec}`` over the port model's
    parameters on ``mesh``."""
    return {n: sh.logical_to_pspec(param_axes(n, cfg), p.shape, mesh, rules)
            for n, p in abstract_model(cfg).named_parameters()}


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    rules=sh.DEFAULT_RULES) -> Dict[str, PartitionSpec]:
    """Every batch input sharded on its leading (batch) dim."""
    return {k: sh.logical_to_pspec(("batch",) + (None,) * (v.dim() - 1),
                                   v.shape, mesh, rules)
            for k, v in batch_specs(cfg, shape).items()}


#: the logical axes of a recurrent block's state leaves (the reference's
#: table, by the field name after the port's ``rec_``/``mlstm_``/``slstm_``
#: prefix)
_CACHE_AXES = {
    "h": ("batch", "rnn_state"),
    "conv": ("batch", None, "rnn_state"),
    "C": ("batch", "heads", None, None),
    "n": ("batch", "heads", None),
    "m": ("batch", "heads"),
    "c": ("batch", None),
}
_KV_KEYS = ("k", "v", "ring_k", "ring_v", "cross_k", "cross_v")


def _cache_leaf_axes(cfg: ModelConfig, key: str, ndim: int) -> Tuple:
    """One layer's axes of the cache entry ``key`` (``ndim`` its dims
    without the stacked layer axis), as the reference's
    ``_cache_leaf_axes`` gives them for that layer's leaf."""
    if key in _KV_KEYS:
        axes = kv_layout(cfg, "decode")
    else:
        field = key.split("_", 1)[1]
        axes = _CACHE_AXES.get(field, ("batch",) + (None,) * (ndim - 1))
    if len(axes) < ndim:
        axes = (None,) * (ndim - len(axes)) + tuple(axes)
    return tuple(axes[:ndim])


def cache_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    rules=sh.DEFAULT_RULES) -> Dict[str, PartitionSpec]:
    """``{cache key: PartitionSpec}`` over the flat cache dict of the dense
    layout at ``shape`` (:func:`decode_specs`). Each entry takes its
    reference leaf's axes (:func:`_cache_leaf_axes`, under
    :func:`~repro_torch.runtime.sharding.use_sharding` of ``mesh`` for
    :func:`kv_layout`) after the stacked layer axis, which stays
    replicated."""
    out = {}
    with sh.use_sharding(mesh, rules):
        for key, t in decode_specs(cfg, shape)[1].items():
            axes = _cache_leaf_axes(cfg, key, t.dim() - 1)
            out[key] = sh.logical_to_pspec((None,) + axes, t.shape, mesh,
                                           rules)
    return out


def replicated(mesh) -> PartitionSpec:
    """The spec of a replicated argument (a step's count, a decode
    position)."""
    return PartitionSpec()


def sharded_bytes(t: torch.Tensor, spec: Sequence, mesh) -> int:
    """Bytes of ``t`` on one card of ``mesh`` under ``spec``: each dim
    divided by the product of its mesh axes' sizes, rounded up."""
    n = 1
    for i, d in enumerate(t.shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n *= -(-d // math.prod(mesh.shape[a] for a in axes))
    return n * t.element_size()


def tree_bytes(tensors: Dict[str, torch.Tensor],
               specs: Dict[str, Sequence], mesh) -> int:
    """:func:`sharded_bytes` summed over a dict of tensors."""
    return sum(sharded_bytes(t, specs[k], mesh) for k, t in tensors.items())


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
