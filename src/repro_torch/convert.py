"""Weight carry-over between the JAX reference's param tree and the port.

:func:`from_jax_params` takes the reference's param tree as numpy arrays
(``{"embed": {"table"}, "unit": [stacked layer tree], "tail": [],
"final_norm", "head"}``) and the reference's butterfly specs of the four
site keys, and returns an :class:`~repro_torch.models.lm.LM` holding the
same weights. The reference derives the truncation indices from
``jax.random``, which the port cannot reproduce, so they come in with the
weights. :func:`load_jax_params` loads such a tree into an existing model
(a checkpoint's params), :func:`to_jax_params` is the inverse (the port's
checkpoints store their params in the reference's layout, layers stacked
as ``unit``), and :func:`names_by_reference_key` names the port parameters
behind each reference leaf, so gradients compare leaf by leaf.
:func:`encdec_from_jax` does the same for the encoder–decoder network: the
reference's ``B``, ``E``, ``D`` and its spec, truncation indices included.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.encdec import EncDecSpec
from repro_torch.core.layers import ButterflySpec
from repro_torch.kernels.context import resolve_device
from repro_torch.models.lm import LM

#: the truncation-index buffers: checkpoints and swaps carry weights only
INDEX_BUFFERS = ("idx_in", "idx_out")


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _port_flat(cfg: ModelConfig, params_np: Mapping) -> Dict[str, Any]:
    """The reference tree as ``{port state name: array}``; the stacked
    ``(R, ...)`` unit leaves split per layer."""
    if params_np.get("tail"):
        raise ValueError("tail layers are outside the port's block_unit")
    (unit,) = params_np["unit"]
    flat = {}
    for path, leaf in _flatten(unit).items():
        for i in range(cfg.n_layers):
            flat[f"layers.{i}.{path}"] = leaf[i]
    rest = {k: v for k, v in params_np.items() if k not in ("unit", "tail")}
    flat.update(_flatten(rest))
    return flat


@torch.no_grad()
def load_jax_params(model: LM, params_np: Mapping) -> LM:
    """Copy a reference-layout param tree into ``model`` in place; the
    truncation-index buffers are kept."""
    flat = _port_flat(model.cfg, params_np)
    for name, t in model.state_dict(keep_vars=True).items():
        if name in flat:
            t.copy_(torch.as_tensor(np.array(flat.pop(name))))
        elif not name.endswith(INDEX_BUFFERS):
            raise KeyError(f"no reference weight for {name}")
    if flat:
        raise KeyError(f"reference weights without a port module: "
                       f"{sorted(flat)}")
    return model


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
    model = load_jax_params(LM(cfg, site_specs=specs), params_np)
    return model.to(dev)


def encdec_from_jax(spec: Any, params_np: Mapping, *,
                    device: Union[str, torch.device, None] = None):
    """The reference's encoder–decoder ``spec`` (any object with the
    :class:`EncDecSpec` fields) and params (``B``, ``E``, ``D`` as numpy) as
    the port's ``(EncDecSpec, {name: float32 tensor on device})``."""
    dev = resolve_device(device)
    port_spec = EncDecSpec(n=spec.n, m=spec.m, d=spec.d, k=spec.k,
                           ell=spec.ell, jl_scale=spec.jl_scale,
                           trunc_idx=tuple(int(i) for i in spec.trunc_idx))
    params = {k: torch.as_tensor(np.array(params_np[k], np.float32),
                                 device=dev) for k in ("B", "E", "D")}
    return port_spec, params


def _reference_key(name: str) -> str:
    """The checkpoint key of the reference leaf holding port parameter
    ``name`` (``layers.3.ffn.up.b_in`` -> ``unit[0].ffn.up.b_in``)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return "unit[0]." + ".".join(parts[2:])
    return name


def names_by_reference_key(names) -> Dict[str, List[str]]:
    """``{reference key: [port names]}`` for the port names ``names`` (index
    buffers dropped); a unit key lists its layers in order, which is the
    order of the reference's stacked leading axis."""
    out: Dict[str, List[str]] = {}
    for name in names:
        if not name.endswith(INDEX_BUFFERS):
            out.setdefault(_reference_key(name), []).append(name)
    for key, group in out.items():
        if key.startswith("unit[0]."):
            group.sort(key=lambda n: int(n.split(".")[1]))
    return out


def _insert(tree: Dict, path: List[str], leaf) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = leaf


def to_jax_params(named: Mapping[str, torch.Tensor]) -> Dict:
    """The reference's param tree, as host numpy arrays, from port tensors
    ``named`` (``model.named_parameters()`` as a dict, or gradients under
    the same names): unit leaves stacked over layers into ``unit[0]``,
    ``tail`` empty."""
    unit: Dict = {}
    tree: Dict = {"unit": [unit], "tail": []}
    for key, group in names_by_reference_key(named).items():
        arrays = [named[n].detach().cpu().numpy() for n in group]
        if key.startswith("unit[0]."):
            _insert(unit, key[len("unit[0]."):].split("."), np.stack(arrays))
        else:
            _insert(tree, key.split("."), arrays[0])
    return tree
