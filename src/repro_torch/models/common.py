"""Shared model components: projections, norms, RoPE, embedding, head,
loss.

A projection site is a plain dense matmul or, when the site is listed in
the config's :class:`~repro_torch.configs.base.ButterflyConfig`, the
paper's butterfly sandwich (§3.2). The static :class:`ButterflySpec` of a
site is derived from (seed, site key, dims) through a seeded
``torch.Generator``; it cannot reproduce the reference's ``jax.random``
derivation, so weights carried over from the reference bring their own
specs (:func:`repro_torch.convert.from_jax_params`).
"""

from __future__ import annotations

import functools
import math
import zlib
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import layers as blayers
from repro_torch.nn.linear import ButterflyLinear, DenseLinear, scaled_normal

SiteSpecs = Optional[Mapping[str, blayers.ButterflySpec]]


def _butterfly_site(cfg: ModelConfig, site: Optional[str]) -> bool:
    return (cfg.butterfly is not None and site is not None
            and site in cfg.butterfly.sites)


@functools.lru_cache(maxsize=None)
def site_butterfly_spec(seed: int, site_key: str, n_in: int, n_out: int,
                        k_factor: float, use_bias: bool
                        ) -> blayers.ButterflySpec:
    """Deterministic spec of one site: a ``torch.Generator`` seeded from the
    site key and the config seed draws the truncation indices."""
    h = zlib.crc32(site_key.encode()) ^ (seed * 2654435761 & 0x7FFFFFFF)
    gen = torch.Generator().manual_seed(h & 0x7FFFFFFF)
    return blayers.make_spec(gen, n_in, n_out, k_factor=k_factor,
                             use_bias=use_bias)


def linear_module(cfg: ModelConfig, n_in: int, n_out: int, *,
                  site: Optional[str] = None, site_key: str = "",
                  generator: Optional[torch.Generator] = None,
                  site_specs: SiteSpecs = None) -> nn.Module:
    """The module of one projection site (dense or butterfly sandwich).
    ``site_specs`` maps a site key to a spec that overrides the seeded
    derivation."""
    key = site_key or site
    if _butterfly_site(cfg, site):
        bc = cfg.butterfly
        spec = (site_specs[key] if site_specs and key in site_specs else
                site_butterfly_spec(bc.seed, key, n_in, n_out, bc.k_factor,
                                    bc.use_bias))
        return ButterflyLinear(spec, generator=generator,
                               dtype=cfg.pdtype())
    return DenseLinear(n_in, n_out, generator=generator, dtype=cfg.pdtype())


def linear_apply(module: nn.Module, x: torch.Tensor,
                 backend: str = "auto") -> torch.Tensor:
    return module(x, backend=backend)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def act_fn(name: str):
    gelu = functools.partial(F.gelu, approximate="tanh")
    return {"swiglu": F.silu, "geglu": gelu, "gelu_mlp": gelu}[name]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) int."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq                 # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


class Embed(nn.Module):
    """Token embedding table (vocab, d_model), ``1/sqrt(d_model)``-scaled
    normal init."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.table = nn.Parameter(scaled_normal(
            generator, (cfg.vocab_size, cfg.d_model), cfg.d_model
        ).to(cfg.pdtype()))


def embed(cfg: ModelConfig, emb: Embed, tokens: torch.Tensor
          ) -> torch.Tensor:
    # gather, then cast: equal to the reference's cast-then-gather, without
    # casting the whole table every call
    x = emb.table[tokens.long()].to(cfg.cdtype())
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype())


def head_module(cfg: ModelConfig, *,
                generator: Optional[torch.Generator] = None,
                site_specs: SiteSpecs = None) -> nn.Module:
    return linear_module(cfg, cfg.d_model, cfg.vocab_size, site="lm_head",
                         generator=generator, site_specs=site_specs)


def head_apply(cfg: ModelConfig, head: nn.Module, x: torch.Tensor,
               backend: str = "auto") -> torch.Tensor:
    logits = linear_apply(head, x, backend)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over valid positions, in float32; logits (..., V), labels
    (...), mask (...) of 0/1 weights."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()
