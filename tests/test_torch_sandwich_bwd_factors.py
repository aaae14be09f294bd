"""The sandwich backward as products with the truncated factors: the plain
twins of the card's backward kernels (`sandwich_bwd_rows_plain`,
`sandwich_bwd_cols_plain`, `sandwich_factors_vjp_plain`, on the factors of
`sandwich_factors_plain`) against the whole backward's oracle
`sandwich_bwd_plain` and against the JAX reference's VJPs.

Inputs come from the reference (`make_spec`'s index sets and
`init_butterfly_linear`'s weights) or from a numpy seed, handed over as
numpy arrays. Tolerances are the reference's gradient tolerances
(`tests/test_kernels_grad.py`): float32 atol = rtol = 1e-5 of max|want|,
bfloat16 8% of max|want| (the twins sum in another order than the stage
chains, and in bfloat16 round `gz` and `du` after that sum).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import butterfly as jbf
from repro.core import layers as jlayers
from repro_torch.kernels import sandwich as ks

from test_torch_sandwich_grad import (CASES, _case, _port_args,
                                      _reference_grads, assert_grad_close)
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

# (n_in, n_out): the smoke config's sites (smollm-135m-butterfly-smoke:
# d_model 64, d_ff 128, vocab 512) and widths that are not powers of two
SHAPES = [(64, 128), (128, 64), (64, 512), (48, 80), (100, 36)]


def _layer(n_in, n_out, rows=9):
    spec = jlayers.make_spec(jax.random.PRNGKey(n_in * 7 + n_out), n_in,
                             n_out, use_bias=False)
    params = jlayers.init_butterfly_linear(jax.random.PRNGKey(n_out), spec)
    rng = np.random.default_rng(n_in + n_out)
    t = {k: torch.from_numpy(np.array(params[k]))
         for k in ("b_in", "core", "b_out")}
    t["idx_in"] = torch.tensor(spec.idx_in, dtype=torch.int32)
    t["idx_out"] = torch.tensor(spec.idx_out, dtype=torch.int32)
    x = rng.normal(size=(rows, n_in)).astype(np.float32)
    g = rng.normal(size=(rows, n_out)).astype(np.float32)
    kw = dict(scale_in=math.sqrt(spec.pad_in / spec.k_in),
              scale_out=math.sqrt(spec.pad_out / spec.k_out))
    return spec, t, torch.from_numpy(x), torch.from_numpy(g), kw


def _composed(x, g, t, kw):
    """The backward through the four twins, as the card runs it:
    ``(dx, d b_in, d core, d b_out)`` and the factors' cotangents."""
    dt = x.dtype
    f_in, f_out = ks.sandwich_factors_plain(
        t["b_in"], t["b_out"], t["idx_in"], t["idx_out"], x.shape[-1],
        g.shape[-1], dt)
    dx, h1, z, dh2, du = ks.sandwich_bwd_rows_plain(x, g, f_in, t["core"],
                                                    f_out, **kw)
    d_f_in, d_core, d_f_out = ks.sandwich_bwd_cols_plain(x, g, h1, z, dh2,
                                                         du)
    d_in, d_out = ks.sandwich_factors_vjp_plain(
        t["b_in"], t["b_out"], t["idx_in"], t["idx_out"], d_f_in, d_f_out,
        dt)
    return (dx, d_in, d_core, d_out), (d_f_in, d_f_out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_in,n_out", SHAPES)
def test_composed_twins_equal_sandwich_bwd_plain(n_in, n_out, dtype):
    _, t, x, g, kw = _layer(n_in, n_out)
    dt = getattr(torch, dtype)
    x, g = x.to(dt), g.to(dt)
    got, _ = _composed(x, g, t, kw)
    want = ks.sandwich_bwd_plain(x, t["b_in"], t["core"], t["b_out"],
                                 t["idx_in"], t["idx_out"], g, n_out=n_out,
                                 **kw)
    assert got[0].dtype == dt and got[0].shape == x.shape
    for name, a, w in zip(("dx", "d b_in", "d core", "d b_out"), got, want):
        assert a.shape == w.shape, name
        assert_grad_close(a.float().numpy(), w.float().numpy(), dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("oracle", [False, True],
                         ids=["pallas_interpret", "sandwich_ref"])
@pytest.mark.parametrize("case", CASES)
def test_composed_twins_match_reference_vjp(case, oracle, dtype):
    """As `test_torch_sandwich_grad.test_sandwich_vjp_matches_reference`
    takes the reference's VJP of vdot(c, sandwich(x)): through its Pallas
    kernel in interpret mode and through its oracle."""
    spec, params, x, c = _case(*case, seed=sum(case) + 1)
    if dtype == "bfloat16":
        c = c.astype(jnp.bfloat16).astype(np.float32)
    want = _reference_grads(spec, params, x, c, dtype, oracle)
    t, idx, kw = _port_args(spec, params, x, dtype)
    t = {k: v.detach() for k, v in t.items()}
    t.update(idx)
    del kw["n_out"]
    dt = getattr(torch, dtype)
    got, _ = _composed(t["x"], torch.from_numpy(c).to(dt), t, kw)
    for name, a, w in zip(("dx", "d b_in", "d core", "d b_out"), got, want):
        assert_grad_close(a.float().numpy(), w, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_in,n_out", [(48, 80), (64, 128), (100, 36)])
def test_factor_vjp_twin_matches_reference(n_in, n_out, dtype):
    """The factor-row VJP twin against `jax.vjp` of the reference's
    `materialize_truncated` (jl_scale off, columns cut to n_in / n_out)
    over the weights rounded to the dtype, for numpy cotangents."""
    spec, t, _, _, _ = _layer(n_in, n_out)
    rng = np.random.default_rng(n_in * n_out)
    d_f_in = rng.normal(size=(spec.k_in, n_in)).astype(np.float32)
    d_f_out = rng.normal(size=(spec.k_out, n_out)).astype(np.float32)
    dt = getattr(torch, dtype)
    got = ks.sandwich_factors_vjp_plain(
        t["b_in"], t["b_out"], t["idx_in"], t["idx_out"],
        torch.from_numpy(d_f_in), torch.from_numpy(d_f_out), dt)
    for w, idx, n, cot, a in ((t["b_in"], spec.idx_in, n_in, d_f_in, got[0]),
                              (t["b_out"], spec.idx_out, n_out, d_f_out,
                               got[1])):
        wr = w.to(dt).float().numpy()
        # under jax.jit: eager jax costs seconds a call
        (want,) = jax.jit(lambda v, c, idx=idx, n=n: jax.vjp(
            lambda v: jbf.materialize_truncated(v, idx, jl_scale=False)[
                :, :n], v)[1](c))(jnp.asarray(wr), jnp.asarray(cot))
        assert_grad_close(a.numpy(), want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padding_gets_no_gradient(dtype):
    """The factors' cotangents are exactly (k1, n_in) and (k2, n_out): no
    padded column enters them. So the stage applied next to the data (the
    input chain's first, the output chain's last: stage 0) gets exactly
    zero gradient at the positions past n_in and n_out, in the twins as in
    the oracle."""
    n_in, n_out = 48, 80
    spec, t, x, g, kw = _layer(n_in, n_out)
    dt = getattr(torch, dtype)
    x, g = x.to(dt), g.to(dt)
    (_, d_in, _, d_out), (d_f_in, d_f_out) = _composed(x, g, t, kw)
    assert d_f_in.shape == (spec.k_in, n_in)
    assert d_f_out.shape == (spec.k_out, n_out)
    want = ks.sandwich_bwd_plain(x, t["b_in"], t["core"], t["b_out"],
                                 t["idx_in"], t["idx_out"], g, n_out=n_out,
                                 **kw)
    for got in ((d_in, d_out), (want[1], want[3])):
        assert not got[0][0, :, n_in:].any()
        assert not got[1][0, :, n_out:].any()
        assert got[0][0, :, :n_in].any() and got[1][0, :, :n_out].any()


@pytest.mark.parametrize("what,n_in,n_out,k", [
    ("n1", 40000, 64, None), ("n2", 64, 300000, None), ("k", 128, 256, 65)])
def test_kernel_widths_are_checked_before_launch(what, n_in, n_out, k):
    """Past n1 = 32,768, n2 = 262,144 or k = 64 the kernels' argument check
    raises ValueError naming the limits (here on CPU tensors: the check
    runs before any launch and needs no card)."""
    spec = jlayers.make_spec(jax.random.PRNGKey(0), n_in, n_out, k_in=k,
                             k_out=k, use_bias=False)
    p1, p2 = int(math.log2(spec.pad_in)), int(math.log2(spec.pad_out))
    x = torch.zeros(2, n_in)
    args = (torch.zeros(p1, 2, spec.pad_in), torch.zeros(spec.k_out,
                                                          spec.k_in),
            torch.zeros(p2, 2, spec.pad_out),
            torch.tensor(spec.idx_in, dtype=torch.int32),
            torch.tensor(spec.idx_out, dtype=torch.int32))
    with pytest.raises(ValueError, match="n1 <= 32768, n2 <= 262144"):
        ks._check_args(x, *args, n_out)
    if what == "n1":
        # the widest input the kernels take passes the check
        spec = jlayers.make_spec(jax.random.PRNGKey(0), 28672, 64,
                                 use_bias=False)
        assert ks._check_args(
            torch.zeros(1, 28672), torch.zeros(15, 2, 32768),
            torch.zeros(spec.k_out, spec.k_in), torch.zeros(6, 2, 64),
            torch.tensor(spec.idx_in, dtype=torch.int32),
            torch.tensor(spec.idx_out, dtype=torch.int32), 64) == (
                32768, spec.k_in, spec.k_out, 64)
