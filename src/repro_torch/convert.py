"""Weight carry-over between the JAX reference's param tree and the port.

:func:`from_jax_params` takes the reference's param tree as numpy arrays
(``{"embed": {"table"}, "unit": [stacked layer tree per unit position],
"tail": [layer tree per tail layer], "final_norm", "head"}``, and for the
frontends ``frontend_proj``, ``enc_unit`` (one ``enc`` layer tree stacked
over ``n_enc_layers``, the port's ``enc_layers.<i>``) and ``enc_norm``;
an MoE layer's ``ffn`` holds ``router``,
``w_gate``, ``w_up`` and ``w_down``, and a tied config's ``head`` is
empty) and the reference's butterfly specs of its site keys, and returns
an :class:`~repro_torch.models.lm.LM` holding the same weights. The
reference derives the truncation indices from ``jax.random``, which the
port cannot reproduce, so they come in with the weights. :func:`load_jax_params` loads such a tree into an existing model
(a checkpoint's params), :func:`to_jax_params` is the inverse (the port's
checkpoints store their params in the reference's layout), and
:func:`names_by_reference_key` names the port parameters behind each
reference leaf, so gradients compare leaf by leaf. Port layer ``L`` is
repeat ``L // U`` of ``unit[L % U]`` below ``R·U`` (``U`` the unit's
length, ``R`` its repeats) and ``tail[L - R·U]`` from there on
(:func:`layer_key`); the functions that need it take the config, and
without one assume a one-type unit and no tail.
:func:`opt_state_to_jax` and :func:`load_jax_opt_state` do the same for the
optimizer state, so a checkpoint either package's ``Trainer`` wrote resumes
in the other.
:func:`encdec_from_jax` does the same for the encoder–decoder network: the
reference's ``B``, ``E``, ``D`` and its spec, truncation indices included;
:func:`sketch_from_jax` for a learned sketch's spec and stage weights, and
:func:`sandwich_from_jax` for one sandwich layer (``repro.nn``'s spec and
params) as a :class:`~repro_torch.nn.ButterflyLinear`.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.encdec import EncDecSpec
from repro_torch.core.layers import ButterflySpec
from repro_torch.core.sketch import SketchSpec
from repro_torch.kernels.context import resolve_device
from repro_torch.models.lm import LM
from repro_torch.nn.linear import ButterflyLinear

#: the truncation-index buffers: checkpoints and swaps carry weights only
INDEX_BUFFERS = ("idx_in", "idx_out")


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def layer_key(cfg: ModelConfig, layer: int) -> str:
    """The reference's list entry holding port layer ``layer``:
    ``unit[i]`` (one repeat of its stacked leaves) or ``tail[j]``."""
    U, R = len(cfg.block_unit), cfg.unit_repeats
    if layer < R * U:
        return f"unit[{layer % U}]"
    return f"tail[{layer - R * U}]"


def _port_flat(cfg: ModelConfig, params_np: Mapping) -> Dict[str, Any]:
    """The reference tree as ``{port state name: array}``; the stacked
    ``(R, ...)`` unit leaves split per layer, tail layers as they are, the
    encoder's stacked ``enc_unit[0]`` split into ``enc_layers.<i>``."""
    U, R = len(cfg.block_unit), cfg.unit_repeats
    flat = {}
    for i, unit in enumerate(params_np["unit"]):
        for path, leaf in _flatten(unit).items():
            for r in range(R):
                flat[f"layers.{r * U + i}.{path}"] = leaf[r]
    for j, layer in enumerate(params_np.get("tail") or ()):
        for path, leaf in _flatten(layer).items():
            flat[f"layers.{R * U + j}.{path}"] = leaf
    for enc in params_np.get("enc_unit") or ():
        for path, leaf in _flatten(enc).items():
            for r in range(leaf.shape[0]):
                flat[f"enc_layers.{r}.{path}"] = leaf[r]
    rest = {k: v for k, v in params_np.items()
            if k not in ("unit", "tail", "enc_unit")}
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


def butterfly_spec_from_jax(s: Any) -> ButterflySpec:
    """The port's spec for a reference sandwich spec (any object with the
    :class:`ButterflySpec` fields), truncation indices included."""
    return ButterflySpec(n_in=s.n_in, n_out=s.n_out, k_in=s.k_in,
                         k_out=s.k_out,
                         idx_in=tuple(int(i) for i in s.idx_in),
                         idx_out=tuple(int(i) for i in s.idx_out),
                         use_bias=s.use_bias, jl_scale=s.jl_scale)


def from_jax_params(cfg: ModelConfig, params_np: Mapping,
                    site_specs: Mapping[str, Any], *,
                    device: Union[str, torch.device, None] = None) -> LM:
    """The reference's params as a port :class:`LM` on ``device``.

    ``site_specs`` maps each butterfly site key of ``cfg`` (of ``mlp_up``,
    ``mlp_gate``, ``mlp_down``, ``lm_head``) to the reference's spec (any
    object with the :class:`ButterflySpec` fields). The stacked
    ``(R, ...)`` unit leaves are split per layer.
    """
    dev = resolve_device(device)
    specs = {key: butterfly_spec_from_jax(s)
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


def sketch_from_jax(spec: Any, w_np, *,
                    device: Union[str, torch.device, None] = None):
    """The reference's sketch ``spec`` (any object with the
    :class:`SketchSpec` fields) and stage weights ``w`` (numpy) as the
    port's ``(SketchSpec, float32 tensor on device)``."""
    dev = resolve_device(device)
    port_spec = SketchSpec(n=spec.n, ell=spec.ell, k=spec.k,
                           trunc_idx=tuple(int(i) for i in spec.trunc_idx),
                           jl_scale=spec.jl_scale)
    return port_spec, torch.as_tensor(np.array(w_np, np.float32),
                                      device=dev)


def sandwich_from_jax(spec: Any, params_np: Mapping, *,
                      device: Union[str, torch.device, None] = None
                      ) -> ButterflyLinear:
    """A reference sandwich layer (its spec and its params ``b_in``,
    ``b_out``, ``core``, ``bias`` as numpy) as a :class:`ButterflyLinear`
    on ``device`` holding the same weights and index sets."""
    dev = resolve_device(device)
    port_spec = butterfly_spec_from_jax(spec)
    names = ("b_in", "b_out", "core") + (("bias",) if spec.use_bias else ())
    params = {k: torch.as_tensor(np.array(params_np[k])) for k in names}
    return ButterflyLinear(port_spec, params=params).to(dev)


def reference_key(name: str, cfg: ModelConfig) -> str:
    """The checkpoint key of the reference leaf holding port parameter
    ``name`` (for gemma3's unit of six, ``layers.8.ffn.up.b_in`` ->
    ``unit[2].ffn.up.b_in``; :func:`layer_key`; an encoder layer's
    ``enc_layers.3.attn.wq`` -> ``enc_unit[0].attn.wq``)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return f"{layer_key(cfg, int(parts[1]))}." + ".".join(parts[2:])
    if parts[0] == "enc_layers":
        return "enc_unit[0]." + ".".join(parts[2:])
    return name


def names_by_reference_key(names, cfg: ModelConfig
                           ) -> Dict[str, List[str]]:
    """``{reference key: [port names]}`` for the port names ``names`` (index
    buffers dropped); a unit key (``unit[i]``, ``enc_unit[0]``) lists its
    layers in order, which is the order of the reference's stacked leading
    axis."""
    out: Dict[str, List[str]] = {}
    for name in names:
        if not name.endswith(INDEX_BUFFERS):
            out.setdefault(reference_key(name, cfg), []).append(name)
    for key, group in out.items():
        if key.startswith(_STACKED):
            group.sort(key=lambda n: int(n.split(".")[1]))
    return out


#: the reference's lists whose entries stack layers on a leading axis
_STACKED = ("unit[", "enc_unit[")
_LIST_KEY = re.compile(r"(unit|tail|enc_unit)\[(\d+)\]\.(.*)")


def _insert(tree: Dict, path: List[str], leaf) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = leaf


def to_jax_params(named: Mapping[str, torch.Tensor], cfg: ModelConfig
                  ) -> Dict:
    """The reference's param tree, as host numpy arrays, from port tensors
    ``named`` (``model.named_parameters()`` as a dict, or gradients under
    the same names) of a model of ``cfg``: each unit position's leaves
    stacked over its repeats into ``unit[i]``, tail layers into
    ``tail[j]``, the encoder's layers stacked into ``enc_unit[0]``,
    ``head`` empty for a tied head. Every array is a copy: none shares
    memory with a tensor that a later step updates in place."""
    tree: Dict = {"unit": [], "tail": []}
    for key, group in names_by_reference_key(named, cfg).items():
        m = _LIST_KEY.fullmatch(key)
        if m is not None and key.startswith(_STACKED):
            leaf = np.stack([named[n].detach().cpu().numpy() for n in group])
        else:
            leaf = named[group[0]].detach().to("cpu", copy=True).numpy()
        if m is None:
            _insert(tree, key.split("."), leaf)
            continue
        entries, i = tree.setdefault(m[1], []), int(m[2])
        entries.extend({} for _ in range(i + 1 - len(entries)))
        _insert(entries[i], m[3].split("."), leaf)
    tree.setdefault("head", {})
    return tree


def opt_state_to_jax(state: Any, cfg: ModelConfig) -> Any:
    """The port's optimizer state in the reference's layout, as host numpy:
    the chain's tuple and its states (``NamedTuple``s, the empty
    ``ClipState()`` slots included) as they are, every ``{name: tensor}``
    tree (Adam's ``mu`` and ``nu``, the compression's error buffers)
    through :func:`to_jax_params`, counts as int32 scalars. The tuple's
    order is the chain's, so it follows the run's own ``TrainConfig`` (a
    compression slot shifts every later index)."""
    if isinstance(state, Mapping):
        return to_jax_params(state, cfg)
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*[opt_state_to_jax(v, cfg) for v in state])
    if isinstance(state, (list, tuple)):
        return type(state)(opt_state_to_jax(v, cfg) for v in state)
    if state is None:
        return None
    return state.detach().cpu().numpy()


def load_jax_opt_state(cfg: ModelConfig, template: Any, tree: Any) -> Any:
    """The inverse of :func:`opt_state_to_jax`: ``tree`` (the reference's
    layout, numpy, as a checkpoint restores it against
    ``opt_state_to_jax(template)``) as a port optimizer state shaped like
    ``template``, each tensor on its template's device and dtype; stacked
    ``unit`` and ``enc_unit`` leaves are split per layer as
    :func:`load_jax_params` splits the params."""
    if isinstance(template, Mapping):
        flat = _port_flat(cfg, tree)
        return {k: torch.as_tensor(np.array(flat[k])).to(t.device, t.dtype)
                for k, t in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*[load_jax_opt_state(cfg, t, h)
                                for t, h in zip(template, tree)])
    if isinstance(template, (list, tuple)):
        return type(template)(load_jax_opt_state(cfg, t, h)
                              for t, h in zip(template, tree))
    if template is None:
        return None
    return torch.as_tensor(np.array(tree)).to(template.device,
                                              template.dtype)
