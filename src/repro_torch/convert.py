"""Weight carry-over from the JAX reference into the port's modules.

:func:`from_jax_params` takes the reference's param tree as numpy arrays
(``{"embed": {"table"}, "unit": [stacked layer tree], "tail": [],
"final_norm", "head"}``) and the reference's butterfly specs of the four
site keys, and returns an :class:`~repro_torch.models.lm.LM` holding the
same weights. The reference derives the truncation indices from
``jax.random``, which the port cannot reproduce, so they come in with the
weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.layers import ButterflySpec
from repro_torch.kernels.context import resolve_device
from repro_torch.models.lm import LM

def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def from_jax_params(cfg: ModelConfig, params_np: Mapping,
                    site_specs: Mapping[str, Any], *,
                    device: Union[str, torch.device, None] = None) -> LM:
    """The reference's params as a port :class:`LM` on ``device``.

    ``site_specs`` maps each butterfly site key (``mlp_up``, ``mlp_gate``,
    ``mlp_down``, ``lm_head``) to the reference's spec (any object with
    the :class:`ButterflySpec` fields). The stacked ``(R, ...)`` unit leaves
    are split per layer.
    """
    dev = resolve_device(device)
    specs = {key: ButterflySpec(
        n_in=s.n_in, n_out=s.n_out, k_in=s.k_in, k_out=s.k_out,
        idx_in=tuple(int(i) for i in s.idx_in),
        idx_out=tuple(int(i) for i in s.idx_out),
        use_bias=s.use_bias, jl_scale=s.jl_scale)
        for key, s in site_specs.items()}
    if params_np.get("tail"):
        raise ValueError("tail layers are outside the port's block_unit")
    (unit,) = params_np["unit"]
    flat = {}
    for path, leaf in _flatten(unit).items():
        for i in range(cfg.n_layers):
            flat[f"layers.{i}.{path}"] = leaf[i]
    rest = {k: v for k, v in params_np.items() if k not in ("unit", "tail")}
    flat.update(_flatten(rest))

    model = LM(cfg, site_specs=specs)
    state = model.state_dict()
    for name, t in state.items():
        if name in flat:
            state[name] = torch.from_numpy(
                np.array(flat.pop(name))).to(t.dtype)
        elif not name.endswith(("idx_in", "idx_out")):
            raise KeyError(f"no reference weight for {name}")
    if flat:
        raise KeyError(f"reference weights without a port module: "
                       f"{sorted(flat)}")
    model.load_state_dict(state)
    return model.to(dev)
