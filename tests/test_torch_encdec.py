"""`repro_torch.core.encdec` and `repro_torch.launch.encdec` on the CPU
against the JAX reference (`repro.core.encdec`, the benches' formulas), on
the reference's spec, truncation and weights carried over with
`convert.encdec_from_jax`, at n = 100 (padded to 128) and n = 64.

Tolerances: forward, loss and gradients 1e-5 relative to max|want| (and
1e-5 of each value); the linear-algebra results (Σ(B), the Theorem 1
prediction, the optimum, the sketch) 1e-4, since the eigen- and SVD solvers
differ between LAPACK builds; loss histories of training rtol 1e-4. FJLT
draws differ between frameworks, so `fjlt_pca_loss` is held by its
properties."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as bcommon
from repro.core import encdec as jed
from repro_torch import convert
from repro_torch.core import encdec as ted
from repro_torch.data import synthetic
from repro_torch.launch import encdec as launch
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

SHAPES = [(100, 40, 4), (64, 48, 6)]        # (n, d, k)


def _case(n, d, k, seed=0):
    """The reference's spec and params, the data (numpy), and the port's
    spec and params carried over."""
    spec = jed.make_spec(jax.random.PRNGKey(seed), n=n, d=d, k=k)
    params = jed.init_params(jax.random.PRNGKey(seed + 1), spec)
    X = synthetic.synthetic_image_matrix(n, d, seed=seed + 2)
    tspec, tparams = convert.encdec_from_jax(
        spec, {k_: np.asarray(v) for k_, v in params.items()}, device="cpu")
    return spec, params, X, tspec, tparams


def _close(got, want, frac=1e-5):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    atol = frac * max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, atol=atol, rtol=frac)


def test_spec_carried_over():
    spec, _, _, tspec, tparams = _case(100, 40, 4)
    assert tspec.pad_n == spec.pad_n == 128
    assert tspec.trunc_idx == spec.trunc_idx and tspec.ell == spec.ell
    assert {k: tuple(v.shape) for k, v in tparams.items()} == {
        "B": (7, 2, 128), "E": (4, spec.ell), "D": (100, 4)}


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_apply_B_forward_loss_and_grads(n, d, k):
    spec, params, X, tspec, tparams = _case(n, d, k)
    tX = torch.from_numpy(X)
    jX = jnp.asarray(X)
    _close(ted.apply_B(tspec, tparams["B"], tX),
           jed.apply_B(spec, params["B"], jX))
    _close(ted.forward(tspec, tparams, tX), jed.forward(spec, params, jX))
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p: jed.loss_fn(spec, p, jX, jX)))(params)
    leaves = {k_: v.clone().requires_grad_() for k_, v in tparams.items()}
    loss = ted.loss_fn(tspec, leaves, tX, tX)
    loss.backward()
    _close(loss, want_loss)
    for name, leaf in leaves.items():
        _close(leaf.grad, want_g[name])


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_theory_matches(n, d, k):
    spec, params, X, tspec, tparams = _case(n, d, k)
    tX, jX = torch.from_numpy(X), jnp.asarray(X)
    B, jB = tparams["B"], params["B"]
    _close(ted.sigma_B(tspec, B, tX, tX), jed.sigma_B(spec, jB, jX, jX),
           1e-4)
    pred = ted.theorem1_loss(tspec, B, tX, tX)
    _close(pred, jed.theorem1_loss(spec, jB, jX, jX), 1e-4)
    _close(ted.pca_loss(tX, tX, k), jed.pca_loss(jX, jX, k), 1e-4)
    Xt = ted.apply_B(tspec, B, tX)
    _close(ted.sketch_rank_k(Xt, tX, k),
           jed.sketch_rank_k(jed.apply_B(spec, jB, jX), jX, k), 1e-4)
    # the optimum: D @ E and its loss (eigenvector signs are the solver's)
    D, E = ted.optimal_DE(tspec, B, tX, tX)
    jD, jE = jed.optimal_DE(spec, jB, jX, jX)
    _close(D @ E, jD @ jE, 1e-4)
    loss = ted.loss_fn(tspec, dict(tparams, D=D, E=E), tX, tX)
    _close(loss, jed.loss_fn(spec, dict(params, D=jD, E=jE), jX, jX), 1e-4)
    _close(loss, pred, 1e-4)                   # Theorem 1 at the optimum


def test_train_and_two_phase_match():
    spec, params, X, tspec, tparams = _case(100, 40, 4)
    tX, jX = torch.from_numpy(X), jnp.asarray(X)
    before = {k: v.clone() for k, v in tparams.items()}
    p1, h1 = ted.train(tspec, tparams, tX, tX, steps=5, lr=3e-3,
                       train_B=False, log_every=1)
    j1, jh1 = jed.train(spec, params, jX, jX, steps=5, lr=3e-3,
                        train_B=False, log_every=1)
    np.testing.assert_allclose(h1, jh1, rtol=1e-4)
    for k, v in tparams.items():               # the caller's params
        assert torch.equal(v, before[k]), k
    assert torch.equal(p1["B"], tparams["B"])  # B frozen in phase 1
    assert not torch.equal(p1["E"], tparams["E"])
    p2, ha, hb = ted.train_two_phase(tspec, p1, tX, tX, 5, 5, lr=1e-3,
                                     log_every=1)
    _, jha, jhb = jed.train_two_phase(spec, j1, jX, jX, 5, 5, lr=1e-3,
                                      log_every=1)
    np.testing.assert_allclose(ha + hb, jha + jhb, rtol=1e-4)
    assert not torch.equal(p2["B"], p1["B"])   # phase 2 trains B
    _close(ted.loss_fn(tspec, p2, tX, tX),
           jed.loss_fn(spec, jed.train_two_phase(
               spec, j1, jX, jX, 5, 5, lr=1e-3)[0], jX, jX), 1e-4)


def test_generators_equal_reference():
    np.testing.assert_array_equal(
        synthetic.synthetic_image_matrix(100, 30, seed=4),
        np.asarray(bcommon.synthetic_image_matrix(100, 30, seed=4)))
    np.testing.assert_array_equal(
        synthetic.gaussian_lowrank(64, 50, 8, seed=1),
        np.asarray(bcommon.gaussian_lowrank(64, 50, 8, seed=1)))
    assert synthetic.synthetic_image_matrix(784, 3).dtype == np.float32


def test_fjlt_pca_loss_properties():
    X = torch.from_numpy(synthetic.synthetic_image_matrix(100, 40, seed=5))
    pca = float(ted.pca_loss(X, X, 4))
    for seed in range(3):
        fj = float(ted.fjlt_pca_loss(torch.Generator().manual_seed(seed), X,
                                     4, 16))
        assert np.isfinite(fj) and fj >= pca * (1 - 1e-5)
    # with ℓ = n the sketch keeps the whole row space: FJLT+PCA is PCA
    full = float(ted.fjlt_pca_loss(torch.Generator().manual_seed(0), X, 4,
                                   128))
    np.testing.assert_allclose(full, pca, rtol=1e-3)


def test_rows_match_reference_formulas():
    """The launcher's rows on the reference's spec and params give the
    numbers the reference benches compute from `repro.core.encdec`."""
    spec, params, X, tspec, tparams = _case(64, 48, 6)
    jX = jnp.asarray(X)
    tX = torch.from_numpy(X)
    row = launch.theorem1_row(tspec, tparams, tX)
    jD, jE = jed.optimal_DE(spec, params["B"], jX, jX)
    measured = float(jed.loss_fn(spec, dict(params, D=jD, E=jE), jX, jX))
    predicted = float(jed.theorem1_loss(spec, params["B"], jX, jX))
    assert row["name"] == "theorem1/n64_k6"
    np.testing.assert_allclose([row["measured"], row["predicted"]],
                               [measured, predicted], rtol=1e-4)
    assert row["derived"].startswith("measured=")

    row = launch.autoenc_row(tspec, tparams, tX, data="mnist_like",
                             generator=torch.Generator().manual_seed(0),
                             steps=4)
    trained, _ = jed.train(spec, params, jX, jX, steps=4, lr=3e-3)
    np.testing.assert_allclose(
        [row["pca"], row["butterfly_closed"], row["butterfly_gd"]],
        [float(jed.pca_loss(jX, jX, 6)), measured,
         float(jed.loss_fn(spec, trained, jX, jX))], rtol=1e-4)
    assert row["fjlt_pca"] >= row["pca"] * (1 - 1e-5)
    assert row["name"] == "autoenc/mnist_like_k6"
    assert [f.split("=")[0] for f in row["derived"].split(";")] == [
        "pca", "fjlt_pca", "butterfly_closed", "butterfly_gd"]

    row = launch.two_phase_row(tspec, tparams, tX, steps1=4, steps2=3)
    j1, _ = jed.train(spec, params, jX, jX, steps=4, lr=3e-3, train_B=False)
    j2, _ = jed.train(spec, j1, jX, jX, steps=3, lr=1e-3, train_B=True)
    np.testing.assert_allclose(
        [row["thm1_prediction"], row["phase1"], row["phase2"], row["pca"]],
        [predicted, float(jed.loss_fn(spec, j1, jX, jX)),
         float(jed.loss_fn(spec, j2, jX, jX)),
         float(jed.pca_loss(jX, jX, 6))], rtol=1e-4)
    assert row["name"] == "two_phase/k6"
    assert [f.split("=")[0] for f in row["derived"].split(";")] == [
        "thm1_prediction", "phase1", "phase2", "pca"]


def test_launch_main_on_cpu(capsys):
    assert launch.main(["--device", "cpu", "--n", "36", "--d", "24", "--k",
                        "3", "--steps", "2", "--steps2", "2"]) == 0
    names = [line.split(",")[0]
             for line in capsys.readouterr().out.splitlines()]
    assert names == ["theorem1/n36_k3", "autoenc/mnist_like_k3",
                     "two_phase/k3"]


def test_launch_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--n", "36", "--steps", "1", "--steps2", "1"])
    spec = ted.make_spec(torch.Generator().manual_seed(0), 32, 8, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ted.init_params(None, spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.encdec_from_jax(spec, {"B": np.zeros((5, 2, 32)),
                                       "E": np.zeros((2, spec.ell)),
                                       "D": np.zeros((32, 2))})


def test_bench_grids_match_reference_benches():
    """The launcher's default grids are the reference benches' own."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "benchmarks")
    from benchmarks import bench_autoencoder, bench_two_phase
    assert launch.AUTOENC_KS == bench_autoencoder.KS
    assert [name for name, _ in bench_autoencoder.DATASETS] == [
        "gaussian1_r32", "gaussian2_r64", "mnist_like"]
    src = open(os.path.join(root, "bench_theorem1.py")).read()
    assert "((48, 4), (96, 8), (128, 16))" in src
    assert launch.THEOREM1_SHAPES == ((48, 4), (96, 8), (128, 16))
    assert "for k in (4, 8, 16)" in open(bench_two_phase.__file__).read()
    assert launch.TWO_PHASE_KS == (4, 8, 16)
