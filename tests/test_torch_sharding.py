"""The port's sharding rules, elastic re-mesh plan and mesh refusals
against the reference, on the CPU and without ranks.

`repro_torch.runtime.sharding` against `repro.runtime.sharding` on the
reference's fake meshes (`tests/test_substrate.py`'s cases, and its
hypothesis property with the port's answer equal to the reference's);
`plan_elastic_mesh` against the reference's over a grid of survivors,
model parallelism, batch and pods, the raise included; a mesh larger than
the world (here, one process: a world of one rank) raising with both ways
to get the ranks named.
"""

import itertools

import pytest

from _hypothesis_compat import given, settings, st
from repro.runtime import fault_tolerance as jft
from repro.runtime import sharding as jsh
from repro_torch.launch import mesh as tmesh
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.runtime import pytree as tpt
from repro_torch.runtime import sharding as tsh
from test_torch_chip_smoke import one_torch_thread  # noqa: F401


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


_MESH_AXES = ("pod", "data", "model")


def _same(axes, shape, mesh, rules=None):
    """The port's spec equals the reference's, entry for entry."""
    got = tsh.logical_to_pspec(axes, shape, mesh, rules or tsh.DEFAULT_RULES)
    want = jsh.logical_to_pspec(axes, shape, mesh, rules or jsh.DEFAULT_RULES)
    assert tuple(got) == tuple(want), (axes, shape, got, want)
    return got


def test_default_rules_equal_the_reference():
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES
    assert tsh.BUTTERFLY_AXES == jsh.BUTTERFLY_AXES
    for name in tsh.BUTTERFLY_AXES:
        assert name in tsh.DEFAULT_RULES


def test_rules_divisibility_fallback():
    for name, dim in (("kv_heads", 8), ("heads", 96)):
        got = tsh.resolve_axis(name, dim, _FakeMesh({"model": 16}),
                               tsh.DEFAULT_RULES, set())
        want = jsh.resolve_axis(name, dim, _FakeMesh({"model": 16}),
                                jsh.DEFAULT_RULES, set())
        assert got == want
    assert tsh.resolve_axis("kv_heads", 8, _FakeMesh({"model": 16}),
                            tsh.DEFAULT_RULES, set()) is None


@pytest.mark.parametrize("axes,shape,mesh", [
    (("embed", "heads", "head_dim"), (64, 16, 64), {"data": 4, "model": 4}),
    (("batch", None), (64, 128), {"pod": 2, "data": 4, "model": 4}),
    (("batch", "seq", "embed"), (6, 32, 64), {"pod": 2, "data": 4}),
    (("vocab", "embed"), (49152, 576), {"data": 16, "model": 16}),
    (("experts", "embed", "expert_mlp"), (64, 2048, 1024),
     {"pod": 2, "data": 16, "model": 16}),
    ((None, None), (3, 5), {"data": 2}),
    (("stages", "butterfly_pair", "butterfly_n"), (11, 2, 2048),
     {"data": 8, "model": 4}),
])
def test_logical_to_pspec_matches_reference(axes, shape, mesh):
    spec = _same(axes, shape, _FakeMesh(mesh))
    assert isinstance(spec, tuple)
    used = [a for part in spec for a in
            ((part,) if isinstance(part, str) else (part or ()))]
    assert len(used) == len(set(used))


@pytest.mark.parametrize("mesh,batch", [
    ({"pod": 2, "data": 4, "model": 4}, 64), ({"data": 8}, 12),
    ({"data": 8}, 3), ({"pod": 2, "data": 4}, 6), ({"model": 4}, 8)])
def test_batch_axes_matches_reference(mesh, batch):
    m = _FakeMesh(mesh)
    got = tsh.batch_axes(m, tsh.DEFAULT_RULES, batch)
    want = jsh.batch_axes(m, jsh.DEFAULT_RULES, batch)
    assert tuple(got) == tuple(want)


@settings(max_examples=200, deadline=None)
@given(
    mesh_sizes=st.tuples(st.integers(1, 4), st.integers(1, 8),
                         st.integers(1, 4)),
    rules=st.fixed_dictionaries({
        name: st.one_of(
            st.none(),
            st.sampled_from(_MESH_AXES),
            st.lists(st.sampled_from(_MESH_AXES), min_size=1, max_size=3,
                     unique=True).map(tuple))
        for name in tsh.BUTTERFLY_AXES + ("batch",)}),
    stages=st.integers(1, 13),
    n=st.integers(1, 64).map(lambda e: 1 << (e % 14)),
    k_out=st.integers(1, 24),
    k_in=st.integers(1, 24),
)
def test_logical_to_pspec_property_matches_reference(mesh_sizes, rules,
                                                     stages, n, k_out,
                                                     k_in):
    """For any rule set over the butterfly axes and any mesh: the port's
    spec equals the reference's, uses each mesh axis at most once, and
    assigns each dim a product that divides it."""
    mesh = _FakeMesh(dict(zip(_MESH_AXES, mesh_sizes)))
    cases = [(("stages", "butterfly_pair", "butterfly_n"), (stages, 2, n)),
             (("butterfly_core_out", "butterfly_core_in"), (k_out, k_in)),
             (("butterfly_bias",), (n,)),
             (("batch", "butterfly_n"), (k_out * 8, n))]
    for axes, shape in cases:
        spec = _same(axes, shape, mesh, rules)
        used = [a for part in spec for a in
                ((part,) if isinstance(part, str) else (part or ()))]
        assert len(used) == len(set(used))
        for dim, part in zip(shape, tuple(spec) + (None,) * len(shape)):
            prod = 1
            for a in (() if part is None else
                      ((part,) if isinstance(part, str) else part)):
                prod *= mesh.shape[a]
            assert dim % prod == 0


def test_spec_pspecs_over_param_spec_trees():
    specs = {"b": [tpt.ParamSpec((3,), axes=(None,), init="zeros")],
             "a": tpt.ParamSpec((64, 96), axes=("embed", "mlp")),
             "w": tpt.ParamSpec((11, 2, 2048), init="fjlt",
                                axes=("stages", "butterfly_pair",
                                      "butterfly_n")),
             "n": 7}
    mesh = _FakeMesh({"data": 4, "model": 4})
    got = tsh.spec_pspecs(specs, mesh)
    assert tuple(got["a"]) == ("data", "model")
    assert tuple(got["b"][0]) == ()
    assert tuple(got["w"]) == ()
    assert got["n"] == 7


def test_constrain_and_the_ambient_context():
    assert tsh.active_ctx() is None
    mesh = _FakeMesh({"data": 2})
    with tsh.use_sharding(mesh) as ctx:
        assert tsh.active_ctx() is ctx and ctx.mesh is mesh
        assert ctx.rules == tsh.DEFAULT_RULES
        x = object()
        assert tsh.constrain(x, ("batch",)) is x
    assert tsh.active_ctx() is None


_GRID = list(itertools.product((1, 3, 4, 7, 8, 16, 31, 64), (1, 2, 4, 8),
                               (1, 4, 6, 12, 256), (1, 2)))


@pytest.mark.parametrize("pods", [1, 2])
def test_plan_elastic_mesh_matches_reference(pods):
    raised = 0
    for alive, mp, batch, p in _GRID:
        if p != pods:
            continue
        try:
            want = jft.plan_elastic_mesh(alive, mp, batch, pods=p)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tft.plan_elastic_mesh(alive, mp, batch, pods=p)
            assert str(got.value) == str(e)
            raised += 1
            continue
        got = tft.plan_elastic_mesh(alive, mp, batch, pods=p)
        assert (got.shape, got.axes, got.dropped_devices, got.n_devices) \
            == (want.shape, want.axes, want.dropped_devices,
                want.n_devices)
    assert raised


@pytest.mark.parametrize("build,what", [
    (lambda: tmesh.butterfly_mesh((2,)), "butterfly mesh_shape (2,)"),
    (lambda: tmesh.butterfly_mesh((2, 4)), "butterfly mesh_shape (2, 4)"),
    (lambda: tmesh.simulated_mesh(8), "simulated mesh (8,)"),
    (lambda: tmesh.make_production_mesh(), "production mesh (16, 16)"),
    (lambda: tmesh.make_mesh((2, 2), ("pod", "data")), "mesh (2, 2)")])
def test_mesh_larger_than_the_world_raises(build, what):
    with pytest.raises(RuntimeError) as e:
        build()
    msg = str(e.value)
    assert msg.startswith(f"{what} needs ")
    assert "the world has 1" in msg
    assert "--simulated-devices" in msg and "torchrun" in msg


def test_one_rank_meshes_need_no_world():
    m = tmesh.butterfly_mesh((1,))
    assert m.shape == {"data": 1} and m.coordinate == (0,)
    assert tmesh.single_device_mesh().shape == {"data": 1, "model": 1}
    assert tmesh.simulated_mesh(1).describe() == "data=1"
    with pytest.raises(ValueError, match="must be"):
        tmesh.butterfly_mesh((1, 1, 1))
    with pytest.raises(ValueError, match="explicit shape"):
        tmesh.simulated_mesh(2, ("pod", "data"))
    with pytest.raises(ValueError, match="does not use"):
        tmesh.simulated_mesh(2, ("data",), (3,))


@pytest.mark.parametrize("how", ["explicit", "ambient", "config", "mesh"])
def test_serve_engine_refuses_a_mesh_context(how):
    """The serving engine resolves a mesh from whichever layer of the
    resolution order sets it, once, at construction: a one-rank mesh
    needs no world, and serves the tokens the unsharded engine serves
    (``engine.mesh_layout()`` ``data=1``). It refuses the contexts it
    cannot serve before any tick: a mesh larger than this one-rank world
    (naming ``--simulated-devices`` and torchrun), and a mesh on an arch
    without butterfly sites."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels.context import ExecutionContext, use_execution
    from repro_torch.models.lm import LM
    from repro_torch.serve import Request, ServeEngine
    cfg = registry.get("smollm-135m-butterfly-smoke")
    model = LM(cfg, generator=torch.Generator().manual_seed(0))

    def layers(shape):
        """(cfg, explicit context, ambient block) asking for ``shape``
        through the layer ``how`` names."""
        if how == "explicit":
            return cfg, ExecutionContext(mesh_shape=shape), None
        if how == "ambient":
            return cfg, None, ExecutionContext(mesh_shape=shape)
        if how == "config":
            return cfg.with_(butterfly=dataclasses.replace(
                cfg.butterfly, mesh_shape=shape)), None, None
        mesh = (tmesh.butterfly_mesh(shape) if shape == (1,)
                else tmesh.make_mesh(shape, ("data",)))
        return cfg, ExecutionContext(mesh=mesh), None

    def engine(shape, arch_cfg=None):
        c, context, block = layers(shape)
        with use_execution(block or ExecutionContext()):
            return ServeEngine(arch_cfg or c, model, slots=2, max_len=32,
                               device="cpu", context=context)

    def tokens(eng):
        prompt = np.arange(3, 12, dtype=np.int32)
        fut = eng.submit(Request(prompt=prompt, max_new_tokens=4))
        eng.run_until_idle(max_ticks=50)
        return fut.result(0).tokens

    eng = engine((1,))
    assert eng.mesh is tmesh.butterfly_mesh((1,))
    assert eng.mesh_layout() == "data=1" and eng.mesh_ranks() == 1
    assert eng.graphs.captures is False          # a CPU engine
    assert tokens(eng) == tokens(ServeEngine(cfg, model, slots=2,
                                             max_len=32, device="cpu"))
    if how != "mesh":
        with pytest.raises(RuntimeError, match=r"needs 2 ranks but the "
                           r"world has 1.*--simulated-devices 2"):
            engine((2,))
    # the config layer carries a mesh only with a butterfly config: there,
    # one without sites
    dense = (cfg.with_(butterfly=dataclasses.replace(
        cfg.butterfly, sites=(), mesh_shape=(1,))) if how == "config"
        else registry.get("smollm-135m-smoke"))
    with pytest.raises(ValueError, match="no butterfly sites"):
        engine((1,), dense)
