"""Gradients of the port's sandwich (`SandwichFn`, `sandwich_bwd_plain`,
`core.layers.butterfly_linear_apply`) against the JAX reference: `jax.grad`
through the reference's Pallas sandwich in interpret mode (its custom-VJP
backward kernel) and through its oracle `ref.sandwich_ref`.

Tolerances are the reference's own gradient tolerances
(`tests/test_kernels_grad.py`): float32 atol = rtol = 1e-5 relative to
max|want|, bfloat16 8% of max|want| (`_assert_close_bf16` at frac=0.08; the
reference's bf16 kernel rounds after every stage, the port once per chain).
On the CPU the Function runs both plain twins, so these tests exercise its
bookkeeping: padding, slicing, index tensors and the grads it returns.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layers as jlayers
from repro.kernels import ref as jref
from repro.kernels.sandwich import one_hot_select, sandwich_matmul
from repro_torch.core import layers as tlayers
from repro_torch.kernels import sandwich as ks
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

CASES = [(64, 64, 8, 8), (32, 128, 16, 12)]   # test_kernels_grad.py:113


def assert_grad_close(got, want, dtype, what=""):
    """float32: atol = rtol = 1e-5 relative to max|want|; bfloat16: 8%."""
    frac = 1e-5 if dtype == "float32" else 0.08
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    atol = frac * max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got, want, rtol=frac, atol=atol,
                               err_msg=what)


def _case(n1, n2, k1, k2, lead=(9,), seed=0):
    """Reference spec and params, an input and an output cotangent."""
    spec = jlayers.make_spec(jax.random.PRNGKey(11 + seed), n1, n2,
                             k_in=k1, k_out=k2, use_bias=False)
    params = jlayers.init_butterfly_linear(jax.random.PRNGKey(12 + seed),
                                           spec)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (n1,)).astype(np.float32)
    c = rng.normal(size=lead + (n2,)).astype(np.float32)
    return spec, params, x, c


def _reference_grads(spec, params, x, c, dtype, oracle):
    n1, n2 = spec.pad_in, spec.pad_out
    sel_in = one_hot_select(spec.idx_in, n1)
    sel_out = one_hot_select(spec.idx_out, n2).T
    si, so = math.sqrt(n1 / spec.k_in), math.sqrt(n2 / spec.k_out)
    xj = jnp.asarray(x, jnp.dtype(dtype))

    def loss(x, b_in, core, b_out):
        if oracle:
            out = jref.sandwich_ref(x, b_in, core, b_out, sel_in, sel_out,
                                    si, so)
        else:
            out = sandwich_matmul(x, b_in, sel_in, core, sel_out, b_out,
                                  scale_in=si, scale_out=so, interpret=True)
        return jnp.vdot(jnp.asarray(c), out.astype(jnp.float32))

    # under jax.jit: eager jax costs seconds a call
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        xj, params["b_in"], params["core"], params["b_out"])


def _port_args(spec, params, x, dtype):
    t = {k: torch.from_numpy(np.array(params[k])).requires_grad_()
         for k in ("b_in", "core", "b_out")}
    t["x"] = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    idx = dict(idx_in=torch.tensor(spec.idx_in, dtype=torch.int32),
               idx_out=torch.tensor(spec.idx_out, dtype=torch.int32))
    kw = dict(scale_in=math.sqrt(spec.pad_in / spec.k_in),
              scale_out=math.sqrt(spec.pad_out / spec.k_out),
              n_out=spec.n_out)
    return t, idx, kw


def _fn_grads(spec, params, x, c, dtype):
    """Gradients of vdot(c, out) through SandwichFn (autograd)."""
    t, idx, kw = _port_args(spec, params, x, dtype)
    out = ks.sandwich_forward(t["x"], t["b_in"], t["core"], t["b_out"],
                              **idx, **kw)
    (out.float() * torch.from_numpy(c)).sum().backward()
    return [t[k].grad for k in ("x", "b_in", "core", "b_out")]


def _plain_grads(spec, params, x, c, dtype):
    """The same gradients, straight from sandwich_bwd_plain."""
    t, idx, kw = _port_args(spec, params, x, dtype)
    g = torch.from_numpy(c).to(getattr(torch, dtype))
    return ks.sandwich_bwd_plain(t["x"], t["b_in"], t["core"], t["b_out"],
                                 idx["idx_in"], idx["idx_out"], g, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("oracle", [False, True],
                         ids=["pallas_interpret", "sandwich_ref"])
@pytest.mark.parametrize("case", CASES)
def test_sandwich_vjp_matches_reference(case, oracle, dtype):
    spec, params, x, c = _case(*case, seed=sum(case))
    if dtype == "bfloat16":   # the cotangent in the working dtype, as g is
        c = c.astype(jnp.bfloat16).astype(np.float32)
    want = _reference_grads(spec, params, x, c, dtype, oracle)
    for route in (_fn_grads, _plain_grads):
        got = route(spec, params, x, c, dtype)
        assert got[0].dtype == getattr(torch, dtype)
        for name, g, w in zip(("dx", "d b_in", "d core", "d b_out"), got,
                              want):
            assert g.dtype == (getattr(torch, dtype) if name == "dx"
                               else torch.float32), name
            assert_grad_close(g.float().numpy(), w, dtype,
                              f"{route.__name__} {name}")


@pytest.mark.parametrize("dims", [(48, 80), (100, 36)])
def test_layer_grads_non_power_of_two(dims):
    """butterfly_linear_apply pads n_in and slices n_out inside the
    Function; its gradients match the reference layer's, bias included."""
    n_in, n_out = dims
    spec = jlayers.make_spec(jax.random.PRNGKey(n_in), n_in, n_out,
                             use_bias=True)
    params = jlayers.init_butterfly_linear(jax.random.PRNGKey(n_out), spec)
    rng = np.random.default_rng(n_in + n_out)
    params["bias"] = jnp.asarray(rng.normal(size=(n_out,)), jnp.float32)
    x = rng.normal(size=(6, n_in)).astype(np.float32)
    c = rng.normal(size=(6, n_out)).astype(np.float32)

    def loss(p, x):
        return jnp.vdot(jnp.asarray(c),
                        jlayers.butterfly_linear_apply(spec, p, x))

    want_p, want_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        params, jnp.asarray(x))
    tspec = tlayers.ButterflySpec(
        n_in=n_in, n_out=n_out, k_in=spec.k_in, k_out=spec.k_out,
        idx_in=spec.idx_in, idx_out=spec.idx_out, use_bias=True)
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = tlayers.butterfly_linear_apply(tspec, tp, tx)
    (out * torch.from_numpy(c)).sum().backward()
    assert_grad_close(tx.grad.numpy(), want_x, "float32", "dx")
    for k in ("b_in", "core", "b_out", "bias"):
        assert_grad_close(tp[k].grad.numpy(), want_p[k], "float32", k)


def test_sandwich_grads_3d_batch():
    spec, params, x, c = _case(32, 128, 16, 12, lead=(2, 3, 5), seed=4)
    want = _reference_grads(spec, params, x, c, "float32", oracle=False)
    got = _fn_grads(spec, params, x, c, "float32")
    assert tuple(got[0].shape) == (2, 3, 5, 32)
    for g, w in zip(got, want):
        assert_grad_close(g.numpy(), w, "float32")


def test_index_tensors_and_scales_get_no_gradient():
    spec, params, x, c = _case(64, 64, 8, 8, seed=2)
    t, idx, kw = _port_args(spec, params, x, "float32")
    args = (t["x"], t["b_in"], t["core"], t["b_out"], idx["idx_in"],
            idx["idx_out"], kw["scale_in"], kw["scale_out"], kw["n_out"],
            "torch")
    ctx = types.SimpleNamespace(
        saved_tensors=tuple(a.detach() for a in args[:6]),
        meta=dict(scale_in=kw["scale_in"], scale_out=kw["scale_out"],
                  n_out=kw["n_out"]), route="torch")
    grads = ks.SandwichFn.backward(ctx, torch.from_numpy(c))
    assert len(grads) == len(args)
    assert all(g is None for g in grads[4:])
    assert all(g is not None for g in grads[:4])
    out = ks.SandwichFn.apply(*args)
    out.sum().backward()
    assert idx["idx_in"].grad is None and idx["idx_out"].grad is None
    assert all(t[k].grad is not None for k in t)
