"""The sharding half of `repro_torch.launch.specs` and `kv_layout` against
the reference's, spec for spec.

On the conftest's 8 simulated jax devices, as `(data 2, model 4)` and
`(pod 2, data 2, model 2)` meshes, for a smoke arch of each block family
(attn, local, rec, mlstm/slstm, moe, enc/xdec, vision): the port's
`batch_shardings`, `param_shardings` (its `PARAM_AXES` table, through
`convert.reference_key`) and `cache_shardings` (the flat cache dict,
mapped layer by layer through `lm.cache_index`) equal the `.spec` of the
reference's `NamedSharding` trees, and `kv_layout` the reference's under
the same ambient mesh. Then the per-card argument bytes on the
`pod16x16` production layout, for two full-size cells, equal those
recomputed from the reference's own specs and rules.
"""

import math

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from repro.configs import registry as jreg
from repro.configs.base import SHAPES_BY_NAME as JSHAPES
from repro.launch import specs as jsp
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.runtime import sharding as jsh
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tsp
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.runtime import sharding as tsh
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

FAMILIES = {"attn": "smollm-135m-butterfly-smoke", "local": "gemma3-27b-smoke",
            "rec": "recurrentgemma-2b-smoke", "xlstm": "xlstm-125m-smoke",
            "moe": "olmoe-1b-7b-smoke", "encdec": "seamless-m4t-medium-smoke",
            "vision": "internvl2-1b-smoke"}
MESHES = {"data2_model4": ((2, 4), ("data", "model")),
          "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"))}
#: the cache sub-tree and field of the reference leaf behind each port key
_REF_LEAF = {"k": ("self", "k"), "v": ("self", "v"),
             "ring_k": ("self", "k"), "ring_v": ("self", "v"),
             "cross_k": ("cross", "k"), "cross_v": ("cross", "v")}


def _meshes(name):
    shape, axes = MESHES[name]
    devices = np.array(jax.devices()[:math.prod(shape)]).reshape(shape)
    return JMesh(devices, axes), tmesh._Layout(shape, axes)


def _norm(spec) -> tuple:
    """A spec's entries without trailing ``None``s."""
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _unstacked(spec) -> tuple:
    """A stacked (``unit``/``enc_unit``) leaf's spec without its repeat
    axis, which the rules leave replicated."""
    spec = tuple(spec)
    assert not spec or spec[0] is None, spec
    return _norm(spec[1:])


def _ref_leaf(tree, key: str):
    """The leaf of a reference tree at a checkpoint key such as
    ``unit[2].ffn.up.b_in``."""
    node = tree
    for part in key.split("."):
        if "[" in part:
            name, idx = part[:-1].split("[")
            node = node[name][int(idx)]
        else:
            node = node[part]
    return node


CASES = [(f, m) for f in FAMILIES for m in MESHES]


@pytest.mark.parametrize("family,mesh", CASES)
def test_sharding_trees_equal_the_reference(family, mesh):
    arch = FAMILIES[family]
    jcfg, tcfg = jreg.get(arch), treg.get(arch)
    jmesh, layout = _meshes(mesh)
    rules = jsh.DEFAULT_RULES

    # batches, at a training and a serving shape
    for name in ("train_4k", "prefill_32k"):
        want = jsp.batch_shardings(jcfg, JSHAPES[name], jmesh, rules)
        got = tsp.batch_shardings(tcfg, SHAPES_BY_NAME[name], layout)
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k]) == tuple(want[k].spec), (name, k)

    # parameters, leaf by leaf through the checkpoint keys
    want = jsp.param_shardings(jcfg, jmesh, rules)
    got = tsp.param_shardings(tcfg, layout)
    assert got and set(got) == {n for n, _ in tsp.abstract_model(
        tcfg).named_parameters()}
    for n, spec in got.items():
        key = convert.reference_key(n, tcfg)
        ref = _ref_leaf(want, key).spec
        stacked = key.startswith(("unit[", "enc_unit["))
        assert _norm(spec) == (_unstacked(ref) if stacked else _norm(ref)), n

    # caches, each port stack against every layer's reference leaf
    shape = SHAPES_BY_NAME["decode_32k"]
    with jsh.use_sharding(jmesh, rules):
        want = jsp.cache_shardings(jcfg, JSHAPES["decode_32k"], jmesh,
                                   rules)
    got = tsp.cache_shardings(tcfg, shape, layout)
    ref_caches = jsp.decode_specs(jcfg, JSHAPES["decode_32k"])[1]
    types = tlm.layer_types(tcfg)
    seen = set()
    for layer, (pre, _) in enumerate(tlm.cache_index(tcfg)):
        t = types[layer]
        if t == "enc":
            continue
        entry = _ref_leaf(want, convert.layer_key(tcfg, layer))
        keys = [k for k in got if k.startswith(pre) and (
            pre or k in ("k", "v"))]
        if t == "xdec":
            keys += ["cross_k", "cross_v"]
        for k in keys:
            sub, field = _REF_LEAF.get(k, (t, k[len(pre):]))
            leaf = entry[sub][field]
            stacked = convert.layer_key(tcfg, layer).startswith("unit[")
            if stacked and k == "slstm_n":
                # the reference's table gives "n" mLSTM's three axes, so a
                # stacked sLSTM "n" (R, B, E) takes ("batch", "heads", None)
                # from its repeat axis on; the port keeps one layer's axes,
                # as the reference's tail leaf gets them (ROADMAP queue 3)
                with jsh.use_sharding(jmesh, rules):
                    axes = jsp._cache_leaf_axes(jcfg, field, 2)
                sds = _ref_leaf(ref_caches, convert.layer_key(
                    tcfg, layer))[sub][field]
                ref = _norm(jsh.logical_to_pspec(axes, sds.shape[1:],
                                                 jmesh, rules))
                assert _norm(leaf.spec) != (None,) + ref
            else:
                ref = (_unstacked(leaf.spec) if stacked
                       else _norm(leaf.spec))
            assert _norm(got[k])[:1] in ((), (None,))
            assert _norm(tuple(got[k])[1:]) == ref, (layer, k)
            seen.add(k)
    assert seen == set(got)


@pytest.mark.parametrize("mesh", [None, *MESHES])
def test_kv_layout_equals_the_reference(mesh):
    """Every family's K/V layout in both modes, outside any mesh and on
    each one."""
    jmesh, layout = _meshes(mesh) if mesh else (None, None)
    for arch in FAMILIES.values():
        jcfg, tcfg = jreg.get(arch), treg.get(arch)
        for mode in ("train", "decode"):
            if mesh is None:
                assert tattn.kv_layout(tcfg, mode) == jattn.kv_layout(
                    jcfg, mode)
                continue
            with jsh.use_sharding(jmesh), tsh.use_sharding(layout):
                assert tattn.kv_layout(tcfg, mode) == jattn.kv_layout(
                    jcfg, mode), (arch, mode)


class _Shape:
    """The reference's rules read a mesh's ``.shape`` alone."""

    def __init__(self, shape):
        self.shape = shape


def _ref_bytes(tree, specs_of, mesh) -> int:
    """Bytes a card of the reference's abstract ``tree`` under its specs."""
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = specs_of(path, leaf)
        n = 1
        for i, d in enumerate(leaf.shape):
            entry = spec[i] if i < len(spec) else None
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            n *= -(-d // math.prod(mesh.shape[a] for a in axes))
        total += n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,shape", [("smollm-135m", "train_4k"),
                                        ("olmoe-1b-7b", "decode_32k")])
def test_per_card_argument_bytes_on_pod16x16(arch, shape):
    """The dry-run's per-card argument bytes on ``pod16x16`` equal those
    recomputed from the reference's specs: its ``model_specs`` through
    its rules, its batch on the batch axis, its cache leaves by its own
    ``_cache_leaf_axes`` under the pod's ambient mesh; Adam's two float32
    moments as the parameters, the count and the decode position
    replicated."""
    jcfg, tcfg = jreg.get(arch), treg.get(arch)
    layout = tmesh.production_layout()
    fake = _Shape(dict(layout.shape))
    rules = jsh.DEFAULT_RULES
    jshape = JSHAPES[shape]
    pspecs = jsh.spec_pspecs(jlm.model_specs(jcfg), fake, rules)
    flat = dict(jax.tree_util.tree_flatten_with_path(pspecs)[0])

    def param_spec(path, leaf):
        return flat[path]

    params = jsp.abstract_model(jcfg)
    want = _ref_bytes(params, param_spec, fake)

    def batch_spec(path, leaf):
        return jsh.logical_to_pspec(
            ("batch",) + (None,) * (len(leaf.shape) - 1), leaf.shape, fake,
            rules)

    if jshape.kind == "train":
        f32 = jax.tree_util.tree_map(
            lambda s: jax.ShapeDtypeStruct(s.shape, np.float32), params)
        want += 2 * _ref_bytes(f32, param_spec, fake) + 4
        want += _ref_bytes(jsp.batch_specs(jcfg, jshape), batch_spec, fake)
    else:
        token, caches, _ = jsp.decode_specs(jcfg, jshape)
        want += _ref_bytes({"t": token}, batch_spec, fake) + 4

        def cache_spec(path, leaf):
            key = path[-1].key
            with jsh.use_sharding(fake, rules):
                axes = jsp._cache_leaf_axes(jcfg, key, len(leaf.shape))
            return jsh.logical_to_pspec(axes, leaf.shape, fake, rules)
        want += _ref_bytes(caches, cache_spec, fake)
    got = dryrun.argument_bytes_per_card(tcfg, SHAPES_BY_NAME[shape], layout)
    assert got["total"] == want
