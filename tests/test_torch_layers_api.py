"""The port's layer API (`repro_torch.core.layers`, `repro_torch.nn`) and
ParamSpec trees (`repro_torch.runtime.pytree`) on the CPU against the JAX
reference (`repro.core.layers`, `repro.nn`, `repro.runtime.pytree`).

Reference draws (`jax.random`) cannot be made in the port, so the
reference's specs, butterflies and params are carried over
(`convert.sandwich_from_jax`) and the port's own draws are held by their
properties. Tolerances: the Proposition 3.1 core, the dense equivalent,
the forward and the gradients 1e-5 of max|want| (and 1e-5 of each value);
counts, bytes, shapes and paths exact."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import nn as jnn
from repro.configs import registry as jreg
from repro.core import layers as jbl
from repro.models import lm as jlm
from repro.runtime import pytree as jpt
from repro_torch import convert
from repro_torch import nn as tnn
from repro_torch.configs import registry as treg
from repro_torch.core import butterfly as tbf
from repro_torch.core import layers as tbl
from repro_torch.launch import paper
from repro_torch.models.lm import LM
from repro_torch.runtime import pytree as tpt
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

SHAPES = [(300, 100), (64, 64)]
TOL = 1e-5
# bench_param_counts.py's layers, as BENCH_quick.json prints them
PARAM_LAYERS = paper.PAPER_LAYERS + paper.LM_HEADS


def _close(got, want, frac=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    atol = frac * max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, atol=atol, rtol=frac)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _reference(n_in, n_out):
    """The reference's layers at one shape: ``create`` + ``init``, and
    ``from_dense`` of a seeded ``W`` with a bias at k 16 / 8; for each its
    spec, params (numpy), and, on seeded ``x`` and cotangent ``g``, its
    forward, gradients w.r.t. params and ``x``, and dense equivalent (under
    ``jax.jit``: eager dispatch costs seconds a call here)."""
    rng = np.random.default_rng(n_out)
    W = (rng.normal(size=(n_out, n_in)) / math.sqrt(n_in)).astype(np.float32)
    b = rng.normal(size=(n_out,)).astype(np.float32)
    x = rng.normal(size=(5, n_in)).astype(np.float32)
    g = rng.normal(size=(5, n_out)).astype(np.float32)
    made = jnn.ButterflyLinear.create(jax.random.PRNGKey(2), n_in, n_out)
    pairs = [(made, made.init(jax.random.PRNGKey(3))),
             jnn.ButterflyLinear.from_dense(
                 jax.random.PRNGKey(4), jnp.asarray(W), bias=jnp.asarray(b),
                 k_in=16, k_out=8)]
    out = []
    for layer, params in pairs:
        def f(p, xx, layer=layer):
            return jnp.sum(layer.apply(p, xx, context="jnp") * g)

        y = jax.jit(lambda p, xx, layer=layer: layer.apply(
            p, xx, context="jnp"))(params, x)
        gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, x)
        out.append(dict(layer=layer, params=_np(params), y=np.asarray(y),
                        gp=_np(gp), gx=np.asarray(gx),
                        dense=np.asarray(jax.jit(layer.to_dense)(params))))
    return W, x, g, out


@pytest.mark.parametrize("n_in,n_out", SHAPES)
def test_dense_core_and_materialize_match_reference(n_in, n_out):
    """``init_from_dense``'s core ``J2 W J1ᵀ`` on the reference's spec and
    butterflies, and the dense equivalent of both reference layers."""
    W, _, _, cases = _reference(n_in, n_out)
    dist = cases[1]
    tspec = convert.butterfly_spec_from_jax(dist["layer"].spec)
    p = {k: torch.tensor(v) for k, v in dist["params"].items()}
    _close(tbl.dense_core(tspec, p["b_in"], p["b_out"], torch.from_numpy(W)),
           dist["params"]["core"])
    for case in cases:
        tspec = convert.butterfly_spec_from_jax(case["layer"].spec)
        p = {k: torch.tensor(v) for k, v in case["params"].items()}
        _close(tbl.butterfly_linear_materialize(tspec, p), case["dense"])


def test_kaiming_core_and_fjlt_butterflies():
    gen = torch.Generator().manual_seed(0)
    spec = tbl.make_spec(gen, 300, 100, k_in=40, k_out=30)
    params = tbl.init_butterfly_linear(gen, spec)
    core = params["core"]
    bound = math.sqrt(1.0 / spec.k_in)
    assert core.shape == (30, 40) and core.dtype == torch.float32
    assert float(core.abs().max()) <= bound
    # uniform on (-bound, bound): mean |u| = bound / 2
    assert abs(float(core.abs().mean()) / bound - 0.5) < 0.05
    for name, n in (("b_in", spec.pad_in), ("b_out", spec.pad_out)):
        B = tbf.materialize(params[name].double())
        assert torch.allclose(B @ B.T, torch.eye(n, dtype=torch.float64),
                              atol=1e-6)
    assert torch.equal(params["bias"], torch.zeros(100))


@pytest.mark.parametrize("name,n1,n2", PARAM_LAYERS)
def test_param_counts_match_reference(name, n1, n2):
    spec = jbl.make_spec(jax.random.PRNGKey(0), n1, n2)
    tspec = convert.butterfly_spec_from_jax(spec)
    assert tbl.param_count(tspec) == jbl.param_count(spec)
    assert tbl.effective_param_count(tspec) == jbl.effective_param_count(spec)
    assert tbl.dense_param_count(n1, n2) == jbl.dense_param_count(n1, n2)
    own = tbl.make_spec(torch.Generator().manual_seed(0), n1, n2)
    assert tbl.param_count(own) == jbl.param_count(spec)


@pytest.mark.parametrize("n_in,n_out", SHAPES)
def test_layer_forward_grads_and_dense_match_reference(n_in, n_out):
    _, x, g, cases = _reference(n_in, n_out)
    for case in cases:
        layer = case["layer"]
        tlayer = convert.sandwich_from_jax(layer.spec, case["params"],
                                           device="cpu")
        assert (tlayer.n_in, tlayer.n_out) == (n_in, n_out)
        assert tlayer.param_count() == layer.param_count()
        assert tlayer.dense_param_count() == layer.dense_param_count()
        xt = torch.from_numpy(x).requires_grad_()
        y = tlayer(xt)
        _close(y, case["y"])
        (y * torch.from_numpy(g)).sum().backward()
        _close(xt.grad, case["gx"])
        for name, leaf in tlayer.params().items():
            _close(leaf.grad, case["gp"][name])
        _close(tlayer.to_dense(), case["dense"])


@pytest.mark.parametrize("n_in,n_out", SHAPES)
def test_create_and_from_dense_on_cpu(n_in, n_out):
    """The port's own draws: the forward equals ``to_dense() @ x + bias``,
    and ``from_dense`` approximates ``W`` (Proposition 3.1) better as k
    grows."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, n_in, generator=gen)
    layer = tnn.ButterflyLinear.create(gen, n_in, n_out, device="cpu")
    assert layer.spec.k_in == tbl.default_k(n_in) and layer.b_in.device.type \
        == "cpu"
    with torch.no_grad():
        layer.bias.copy_(torch.randn(n_out, generator=gen))
        _close(layer(x), x @ layer.to_dense().T + layer.bias)
    W = torch.randn(n_out, n_in, generator=gen) / math.sqrt(n_in)
    errs = []
    for k in (4, 32):
        dist = tnn.ButterflyLinear.from_dense(gen, W, k_in=k, k_out=k,
                                              device="cpu")
        assert not dist.spec.use_bias
        with torch.no_grad():
            _close(dist(x), x @ dist.to_dense().T)
            errs.append(float((dist.to_dense() - W).norm() / W.norm()))
    assert errs[1] < errs[0]
    biased = tnn.ButterflyLinear.from_dense(gen, W.numpy(), bias=np.ones(
        n_out, np.float32), device="cpu")
    assert torch.equal(biased.bias.detach(), torch.ones(n_out))


def test_create_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnn.ButterflyLinear.create(None, 8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnn.ButterflyLinear.from_dense(None, torch.zeros(8, 8))


def test_sandwich_linear_requires_core_sizes():
    for kw in ({}, {"k_in": 8}, {"k_out": 8}):
        with pytest.raises(TypeError, match="explicit k_in and k_out"):
            tnn.SandwichLinear.create(None, 64, 32, device="cpu", **kw)
    layer = tnn.SandwichLinear.create(None, 64, 32, 8, 5, device="cpu")
    assert isinstance(layer, tnn.SandwichLinear)
    assert (layer.spec.k_in, layer.spec.k_out) == (8, 5)
    assert layer.core.shape == (5, 8)


def test_model_site_constructor_init_unchanged():
    """``ButterflyLinear(spec, generator=...)`` draws the model sites' init
    as before: FJLT in, FJLT out, then a ``scaled_normal`` core."""
    spec = tbl.make_spec(torch.Generator().manual_seed(1), 96, 40)
    layer = tnn.ButterflyLinear(spec, generator=torch.Generator()
                                .manual_seed(5), scale=0.5)
    gen = torch.Generator().manual_seed(5)
    want = {"b_in": tbf.fjlt_weights(gen, spec.pad_in),
            "b_out": tbf.fjlt_weights(gen, spec.pad_out),
            "core": 0.5 / math.sqrt(spec.k_in)
            * torch.randn(spec.k_out, spec.k_in, generator=gen),
            "bias": torch.zeros(40)}
    for name, t in layer.params().items():
        assert torch.equal(t.detach(), want[name]), name
    assert layer.idx_in.tolist() == list(spec.idx_in)


def _port_specs(tree):
    if isinstance(tree, dict):
        return {k: _port_specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_port_specs(v) for v in tree)
    if jpt.is_spec(tree):
        return tpt.ParamSpec(tuple(tree.shape), np.dtype(tree.dtype).name,
                             tuple(tree.axes), tree.init, tree.scale,
                             tree.fan_in_dim)
    return tree


@pytest.mark.parametrize("arch,count", [
    ("smollm-135m-smoke", 139584), ("smollm-135m-butterfly-smoke", 83314)])
def test_param_spec_trees_match_reference(arch, count):
    specs = jlm.model_specs(jreg.get(arch))
    tspecs = _port_specs(specs)
    assert tpt.param_count(tspecs) == jpt.param_count(specs) == count
    assert tpt.param_bytes(tspecs) == jpt.param_bytes(specs)
    want = jpt.tree_paths(jpt.abstract_params(specs))
    meta = tpt.tree_paths(tpt.abstract_params(tspecs))
    made = tpt.tree_paths(tpt.init_params(torch.Generator().manual_seed(0),
                                          tspecs))
    assert list(meta) == list(want) == list(made)
    for path, w in want.items():
        for t in (meta[path], made[path]):
            assert tuple(t.shape) == tuple(w.shape), path
            assert str(t.dtype) == f"torch.{np.dtype(w.dtype).name}", path
        assert meta[path].is_meta
        assert made[path].device.type == "cpu"
        assert bool(torch.isfinite(made[path].float()).all()), path
    # the port's LM holds as many parameters as the reference's tree
    assert sum(p.numel() for p in LM(treg.get(arch)).parameters()) == count


def test_param_spec_rules():
    with pytest.raises(ValueError, match="rank"):
        tpt.ParamSpec((2, 3), axes=("embed",))
    with pytest.raises(ValueError, match="unknown init"):
        tpt.init_params(None, {"w": tpt.ParamSpec((2,), init="nope")})
    gen = torch.Generator().manual_seed(0)
    tree = tpt.init_params(gen, {
        "z": tpt.ParamSpec((3,), init="zeros"),
        "o": tpt.ParamSpec((3,), "bfloat16", init="ones"),
        "b": [tpt.ParamSpec((2, 3, 2, 8), init="fjlt")],
        "s": tpt.ParamSpec((4096, 64), init="scaled_normal", scale=2.0,
                           fan_in_dim=0),
        "keep": 7})
    assert tree["keep"] == 7 and tree["o"].dtype == torch.bfloat16
    assert torch.equal(tree["z"], torch.zeros(3))
    stacked = tree["b"][0]
    for i in range(2):
        B = tbf.materialize(stacked[i].double())
        assert torch.allclose(B @ B.T, torch.eye(8, dtype=torch.float64),
                              atol=1e-6)
    assert not torch.equal(stacked[0], stacked[1])
    assert abs(float(tree["s"].std()) - 2.0 / 64) < 2e-3
    assert tpt.tree_paths({"a": [1, {"b": 2}]}) == {"a/0": 1, "a/1/b": 2}
