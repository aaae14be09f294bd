"""`repro_torch.core.butterfly` and `kernels.ref.butterfly_ref` against the
JAX reference at n in {8, 64, 1024}, float32, atol/rtol 1e-5. The FJLT
initialiser is held by its property (orthogonality): the two frameworks
draw different random signs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import butterfly as jbf
from repro.kernels import ref as jref
from repro_torch.core import butterfly as tbf
from repro_torch.kernels import ref as tref
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

TOL = 1e-5
NS = (8, 64, 1024)


def _inputs(n, seed=0, rows=5):
    rng = np.random.default_rng(seed)
    p = int(np.log2(n))
    w = rng.normal(size=(p, 2, n)).astype(np.float32) / np.sqrt(2)
    x = rng.normal(size=(rows, n)).astype(np.float32)
    return w, x


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("n", NS)
def test_stage_swap_matches(n):
    _, x = _inputs(n)
    for s in range(int(np.log2(n))):
        _close(tbf.stage_swap(torch.from_numpy(x), 1 << s),
               jbf.stage_swap(jnp.asarray(x), 1 << s))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("transpose", [False, True])
def test_butterfly_apply_and_ref_match(n, transpose):
    w, x = _inputs(n, seed=n)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    want = jref.butterfly_ref(jnp.asarray(w), jnp.asarray(x),
                              transpose=transpose)
    _close(tref.butterfly_ref(tw, tx, transpose=transpose), want)
    fn = tbf.butterfly_transpose_apply if transpose else tbf.butterfly_apply
    _close(fn(tw, tx), want)


@pytest.mark.parametrize("n", NS)
def test_transpose_is_the_adjoint(n):
    w, x = _inputs(n, seed=1)
    _, y = _inputs(n, seed=2)
    tw = torch.from_numpy(w).double()
    bx = tbf.butterfly_apply(tw, torch.from_numpy(x).double())
    bty = tbf.butterfly_transpose_apply(tw, torch.from_numpy(y).double())
    torch.testing.assert_close((bx * torch.from_numpy(y).double()).sum(),
                               (torch.from_numpy(x).double() * bty).sum())


@pytest.mark.parametrize("n", NS)
def test_fjlt_weights_are_orthogonal(n):
    w = tbf.fjlt_weights(torch.Generator().manual_seed(n), n,
                         dtype=torch.float64)
    B = tbf.butterfly_apply(w, torch.eye(n, dtype=torch.float64))
    torch.testing.assert_close(B @ B.T, torch.eye(n, dtype=torch.float64))
    assert w.shape == (int(np.log2(n)), 2, n)


@pytest.mark.parametrize("n", NS)
def test_truncation_roundtrip_matches(n):
    _, x = _inputs(n, seed=3)
    ell = max(1, int(np.log2(n)))
    idx = tbf.truncation_indices(torch.Generator().manual_seed(7), n, ell)
    assert list(idx) == sorted(set(idx)) and len(idx) == ell
    assert all(0 <= i < n for i in idx)
    assert idx == tbf.truncation_indices(torch.Generator().manual_seed(7),
                                         n, ell)
    y = tbf.truncate(torch.from_numpy(x), idx, n)
    _close(y, jbf.truncate(jnp.asarray(x), idx, n))
    _close(tbf.untruncate(y, idx, n),
           jbf.untruncate(jnp.asarray(y.numpy()), idx, n))


def test_dims_and_validation():
    assert [tbf.padded_dim(n) for n in (1, 5, 8, 576, 49152)] == \
        [jbf.padded_dim(n) for n in (1, 5, 8, 576, 49152)]
    assert tbf.num_stages(1024) == 10
    with pytest.raises(ValueError):
        tbf.num_stages(12)
    with pytest.raises(ValueError):
        tbf.butterfly_apply(torch.zeros(3, 2, 8), torch.zeros(2, 16))
