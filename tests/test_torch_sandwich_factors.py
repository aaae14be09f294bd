"""The sandwich forward as truncated factors and row products
(`repro_torch.kernels.sandwich.sandwich_factors_plain`,
`sandwich_rows_plain`, the twins of the card's factor and row kernels, and
`repro_torch.core.butterfly.materialize_truncated`) against the JAX
reference.

Inputs come from the reference (`make_spec`'s index sets, the layer's own
`init_butterfly_linear` weights, or the reference's Gaussian
`random_weights`) and from a numpy seed, handed over as numpy arrays.
Tolerances are the reference's (`tests/test_kernels.py`): float32 1e-5,
bfloat16 4e-2, as atol = rtol.

* The factors are held against the reference's `materialize_truncated`
  (jl_scale off) over the weights rounded to the dtype. Its dense n x n
  matrix takes gigabytes at n = 8192, so there each factor row is held
  against the reference's transposed butterfly (`ref.butterfly_ref`) on
  the one-hot row instead: the same rows, O(k n log n).
* The rows twin on those factors is held against the stage-by-stage twin
  `sandwich_plain` and against the reference oracle `ref.sandwich_ref`.
  The oracle runs every operation in x's dtype, so in bfloat16 it rounds
  after every stage where the kernels round three times; the bfloat16
  comparison runs the oracle in float32 on the same bfloat16-rounded x and
  weights.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import butterfly as jbf
from repro.core import layers as jlayers
from repro.kernels import ref as jref
from repro.kernels.sandwich import one_hot_select
from repro_torch.core import butterfly as tbf
from repro_torch.kernels import sandwich as ks
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

TOLS = {"float32": 1e-5, "bfloat16": 4e-2}
# (n_in, n_out, k): k None is the paper's log2 n on each side
SHAPES = [(48, 80, None), (100, 36, None), (576, 1536, None),
          (1536, 576, None), (64, 8192, None), (128, 256, 64)]
DENSE_MAX = 2048          # widest butterfly materialized densely


@functools.lru_cache(maxsize=None)
def _case(shape, weights, rows=7):
    """The reference's spec and weights for ``shape``, drawn once a case
    for the file (eager jax draws them one program a leaf)."""
    n_in, n_out, k = shape
    spec = jlayers.make_spec(jax.random.PRNGKey(n_in + n_out), n_in, n_out,
                             k_in=k, k_out=k, use_bias=False)
    params = jlayers.init_butterfly_linear(jax.random.PRNGKey(n_in), spec)
    if weights == "gaussian":
        k1, k2 = jax.random.split(jax.random.PRNGKey(n_out))
        params["b_in"] = jbf.random_weights(k1, spec.pad_in)
        params["b_out"] = jbf.random_weights(k2, spec.pad_out)
    a = {k: np.array(v) for k, v in params.items()}
    a["idx_in"] = np.array(spec.idx_in, np.int32)
    a["idx_out"] = np.array(spec.idx_out, np.int32)
    a["x"] = np.random.default_rng(n_in).normal(
        size=(rows, n_in)).astype(np.float32)
    scales = dict(scale_in=math.sqrt(spec.pad_in / spec.k_in),
                  scale_out=math.sqrt(spec.pad_out / spec.k_out))
    return spec, a, scales


def _t(a):
    return {k: torch.from_numpy(v) for k, v in a.items()}


def _reference_rows(w, idx, n, jdt):
    """Rows ``idx`` of the reference butterfly over ``w`` rounded to
    ``jdt``, columns below ``n``, float32."""
    w = jnp.asarray(w).astype(jdt).astype(jnp.float32)
    width = w.shape[-1]
    if width <= DENSE_MAX:
        m = _materialize(w, tuple(int(i) for i in idx))
    else:
        onehot = jnp.zeros((len(idx), width), jnp.float32)
        onehot = onehot.at[jnp.arange(len(idx)), jnp.asarray(idx)].set(1.0)
        m = _transposed(w, onehot)
    return np.asarray(m)[:, :n]


# the reference's functions under jax.jit (eager jax costs seconds a call)
_materialize = jax.jit(lambda w, idx: jbf.materialize_truncated(
    w, list(idx), jl_scale=False), static_argnums=1)
_transposed = jax.jit(lambda w, x: jref.butterfly_ref(w, x, transpose=True))
_sandwich_ref = jax.jit(jref.sandwich_ref)


@pytest.mark.parametrize("weights", ["layer", "gaussian"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_factors_plain_match_reference_rows(shape, dtype, weights):
    spec, a, _ = _case(shape, weights)
    t = _t(a)
    f_in, f_out = ks.sandwich_factors_plain(
        t["b_in"], t["b_out"], t["idx_in"], t["idx_out"], spec.n_in,
        spec.n_out, getattr(torch, dtype))
    assert f_in.shape == (spec.k_in, spec.n_in)
    assert f_out.shape == (spec.k_out, spec.n_out)
    assert f_in.dtype == f_out.dtype == torch.float32
    jdt = jnp.dtype(dtype)
    tol = TOLS[dtype]
    np.testing.assert_allclose(
        f_in.numpy(), _reference_rows(a["b_in"], a["idx_in"], spec.n_in, jdt),
        atol=tol, rtol=tol)
    np.testing.assert_allclose(
        f_out.numpy(),
        _reference_rows(a["b_out"], a["idx_out"], spec.n_out, jdt),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_rows_plain_matches_stage_twin_and_oracle(shape, dtype):
    spec, a, scales = _case(shape, "layer")
    t = _t(a)
    dt = getattr(torch, dtype)
    x = t["x"].to(dt)
    f_in, f_out = ks.sandwich_factors_plain(
        t["b_in"], t["b_out"], t["idx_in"], t["idx_out"], spec.n_in,
        spec.n_out, dt)
    got = ks.sandwich_rows_plain(x, f_in, t["core"], f_out, **scales)
    assert got.shape == (x.shape[0], spec.n_out) and got.dtype == dt
    got = got.float().numpy()
    tol = TOLS[dtype]
    stages = ks.sandwich_plain(x, t["b_in"], t["core"], t["b_out"],
                               t["idx_in"], t["idx_out"], n_out=spec.n_out,
                               **scales)
    np.testing.assert_allclose(got, stages.float().numpy(), atol=tol,
                               rtol=tol)
    # the oracle in float32 on the dtype-rounded inputs
    n1, n2 = spec.pad_in, spec.pad_out

    def rounded(v):
        return jnp.asarray(v).astype(jnp.dtype(dtype)).astype(jnp.float32)

    xo = rounded(np.pad(a["x"], ((0, 0), (0, n1 - spec.n_in))))
    want = _sandwich_ref(
        xo, rounded(a["b_in"]), jnp.asarray(a["core"]), rounded(a["b_out"]),
        one_hot_select(a["idx_in"], n1), one_hot_select(a["idx_out"], n2).T,
        scales["scale_in"], scales["scale_out"])
    np.testing.assert_allclose(got, np.asarray(want)[:, :spec.n_out],
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("n,ell", [(8, 3), (256, 8), (2048, 11)])
@pytest.mark.parametrize("jl_scale", [False, True])
def test_materialize_truncated_matches_reference(n, ell, jl_scale):
    """The port's O(ell n log n) rows against the reference's dense
    materialization."""
    rng = np.random.default_rng(n)
    w = (rng.normal(size=(int(math.log2(n)), 2, n)) / math.sqrt(2)).astype(
        np.float32)
    idx = sorted(int(i) for i in rng.choice(n, ell, replace=False))
    got = tbf.materialize_truncated(torch.from_numpy(w), idx,
                                    jl_scale=jl_scale)
    want = jbf.materialize_truncated(jnp.asarray(w), idx, jl_scale=jl_scale)
    assert got.shape == (ell, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
