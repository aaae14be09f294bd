"""The port's sandwich (`repro_torch.kernels.sandwich`, `core.layers`)
against the JAX reference: the plain twin of the CUDA kernel vs the Pallas
kernel in interpret mode and vs the reference oracle, at the reference's
own sandwich tolerances (float32 2e-4, bfloat16 5e-2), and the sandwich
layer on the reference's spec and params with leading axes and ragged
batches."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layers as jlayers
from repro.kernels import ref as jref
from repro.kernels.sandwich import one_hot_select, sandwich_matmul
from repro_torch.core import layers as tlayers
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sandwich as ks
from repro_torch.nn import ButterflyLinear
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

TOLS = {"float32": 2e-4, "bfloat16": 5e-2}
SHAPES = [(64, 128, 6, 7), (128, 64, 7, 6), (32, 512, 5, 9)]


def _inputs(n1, n2, k1, k2, seed, rows=9):
    rng = np.random.default_rng(seed)
    p1, p2 = int(np.log2(n1)), int(np.log2(n2))
    return dict(
        x=rng.normal(size=(rows, n1)).astype(np.float32),
        b_in=(rng.normal(size=(p1, 2, n1)) / np.sqrt(2)).astype(np.float32),
        b_out=(rng.normal(size=(p2, 2, n2)) / np.sqrt(2)).astype(np.float32),
        core=(rng.normal(size=(k2, k1)) / np.sqrt(k1)).astype(np.float32),
        idx_in=np.sort(rng.choice(n1, k1, replace=False)).astype(np.int32),
        idx_out=np.sort(rng.choice(n2, k2, replace=False)).astype(np.int32))


def _plain(a, dtype, n_out=None):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    n1, n2 = a["b_in"].shape[-1], a["b_out"].shape[-1]
    k1, k2 = len(a["idx_in"]), len(a["idx_out"])
    return ks.sandwich_plain(
        t["x"].to(dtype), t["b_in"], t["core"], t["b_out"], t["idx_in"],
        t["idx_out"], scale_in=math.sqrt(n1 / k1),
        scale_out=math.sqrt(n2 / k2), n_out=n2 if n_out is None else n_out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret_and_oracle(shape, dtype):
    n1, n2, k1, k2 = shape
    a = _inputs(n1, n2, k1, k2, seed=n1 + n2)
    jdt = jnp.dtype(dtype)
    sel_in = one_hot_select(a["idx_in"], n1)
    sel_out = one_hot_select(a["idx_out"], n2).T
    scales = dict(scale_in=math.sqrt(n1 / k1), scale_out=math.sqrt(n2 / k2))
    x = jnp.asarray(a["x"], jdt)
    # the reference's kernel and oracle under jax.jit: eager jax costs
    # seconds a call
    kernel = jax.jit(functools.partial(sandwich_matmul, interpret=True,
                                       **scales))(
        x, jnp.asarray(a["b_in"]), sel_in, jnp.asarray(a["core"]), sel_out,
        jnp.asarray(a["b_out"]))
    oracle = jax.jit(functools.partial(jref.sandwich_ref, **scales))(
        x, jnp.asarray(a["b_in"]), jnp.asarray(a["core"]),
        jnp.asarray(a["b_out"]), sel_in, sel_out)
    got = _plain(a, getattr(torch, dtype)).float().numpy()
    tol = TOLS[dtype]
    for want in (kernel, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_oracle_matches_jax_oracle(dtype):
    n1, n2, k1, k2 = SHAPES[0]
    a = _inputs(n1, n2, k1, k2, seed=11)
    sel_in = np.array(one_hot_select(a["idx_in"], n1))
    sel_out = np.array(one_hot_select(a["idx_out"], n2).T)
    scales = (math.sqrt(n1 / k1), math.sqrt(n2 / k2))
    want = jref.sandwich_ref(
        jnp.asarray(a["x"], jnp.dtype(dtype)), jnp.asarray(a["b_in"]),
        jnp.asarray(a["core"]), jnp.asarray(a["b_out"]),
        jnp.asarray(sel_in), jnp.asarray(sel_out), *scales)
    got = tref.sandwich_ref(
        torch.from_numpy(a["x"]).to(getattr(torch, dtype)),
        torch.from_numpy(a["b_in"]), torch.from_numpy(a["core"]),
        torch.from_numpy(a["b_out"]), torch.from_numpy(sel_in),
        torch.from_numpy(sel_out), *scales)
    tol = TOLS[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_plain_pads_and_slices_like_explicit_padding():
    n1, n2, k1, k2 = SHAPES[2]
    a = _inputs(n1, n2, k1, k2, seed=5)
    short = dict(a, x=a["x"][:, :20])
    padded = dict(a, x=np.pad(a["x"][:, :20], ((0, 0), (0, n1 - 20))))
    torch.testing.assert_close(_plain(short, torch.float32, n_out=300),
                               _plain(padded, torch.float32)[:, :300])


def _reference_layer(n_in, n_out, seed):
    spec = jlayers.make_spec(jax.random.PRNGKey(seed), n_in, n_out,
                             use_bias=True)
    params = jlayers.init_butterfly_linear(jax.random.PRNGKey(seed + 1),
                                           spec)
    params["bias"] = jnp.asarray(
        np.random.default_rng(seed).normal(size=(n_out,)), jnp.float32)
    tspec = tlayers.ButterflySpec(
        n_in=spec.n_in, n_out=spec.n_out, k_in=spec.k_in, k_out=spec.k_out,
        idx_in=spec.idx_in, idx_out=spec.idx_out, use_bias=True)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    return spec, params, tspec, tparams


@pytest.mark.parametrize("dims", [(48, 80), (100, 36)])
@pytest.mark.parametrize("lead", [(7,), (2, 3), (1, 5, 1)])
def test_linear_apply_matches_reference_layer(dims, lead):
    spec, params, tspec, tparams = _reference_layer(*dims, seed=sum(dims))
    x = np.random.default_rng(len(lead)).normal(
        size=lead + (dims[0],)).astype(np.float32)
    want = jlayers.butterfly_linear_apply(spec, params, jnp.asarray(x))
    got = tlayers.butterfly_linear_apply(tspec, tparams,
                                         torch.from_numpy(x))
    assert tuple(got.shape) == lead + (dims[1],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


def test_module_matches_functional_layer():
    spec, params, tspec, tparams = _reference_layer(100, 36, seed=3)
    layer = ButterflyLinear(tspec)
    layer.load_state_dict(
        {**tparams, "idx_in": layer.idx_in, "idx_out": layer.idx_out})
    x = torch.randn(4, 100, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(
            layer(x), tlayers.butterfly_linear_apply(tspec, tparams, x))
    with pytest.raises(ValueError):
        layer(torch.zeros(4, 99))


def test_cuda_backend_rejects_cpu_tensors():
    a = _inputs(*SHAPES[0], seed=0)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    with pytest.raises(ValueError, match="CUDA"):
        ks.sandwich_forward(t["x"], t["b_in"], t["core"], t["b_out"],
                            t["idx_in"], t["idx_out"], scale_in=1.0,
                            scale_out=1.0, n_out=128, context="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        ks.sandwich_forward(t["x"], t["b_in"], t["core"], t["b_out"],
                            t["idx_in"], t["idx_out"], scale_in=1.0,
                            scale_out=1.0, n_out=128, context="pallas")
