"""`repro_torch.kernels.butterfly` on the CPU against the reference: the
plain twin and `butterfly_apply(..., context="torch")` (through
`ButterflyFn`), forward and gradients, both directions, at n in {8, 64,
256} with 1, 11 and 300 rows and a (2, 3, 5, n) batch. The smallest case
of each dtype is held against the reference's fused kernel
`butterfly_matmul(..., interpret=True)`, the others against its plain
reference `repro.kernels.ref.butterfly_ref` (jitted once a shape), as the
reference's own tests hold its kernel. float32 within 1e-5·max|want| + 1e-5·|want|
(dw sums over up to 300 rows in another order than the reference);
bfloat16 within 5% of max|want|, the reference's own bf16 tolerance
(`tests/test_kernels_grad.py:_assert_close_bf16`). The twin of the backward
kernel's summation order, `butterfly_bwd_tiled_plain`, is held the same way
and against the plain twin. Also the port of the reference's CI gate on the
backward's stage applications."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import butterfly as jkern
from repro.kernels.butterfly import butterfly_matmul
from repro.kernels.ref import butterfly_ref
from repro_torch.kernels import butterfly as kb
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

# (n, leading shape): each row count and the batch once, n = 8 twice
CASES = [(8, (1,)), (8, (2, 3, 5)), (64, (11,)), (256, (300,))]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(n, lead, seed):
    rng = np.random.default_rng(seed)
    p = int(np.log2(n))
    w = (rng.normal(size=(p, 2, n)) / np.sqrt(2)).astype(np.float32)
    x = rng.normal(size=(*lead, n)).astype(np.float32)
    c = rng.normal(size=(*lead, n)).astype(np.float32)
    return w, x, c


@functools.lru_cache(maxsize=None)
def _reference(transpose, interpret):
    """Jitted ``(x, w, c) -> (y, dx, dw)``: the reference's butterfly and
    the gradients of ``vdot(c, y)``, through its fused kernel in interpret
    mode or through its plain reference (weights rounded to x's dtype,
    the chain in float32, as the kernel's precision points)."""
    def fwd(x, w):
        if interpret:
            return butterfly_matmul(x, w, transpose=transpose,
                                    interpret=True)
        wr = w.astype(x.dtype).astype(jnp.float32)
        return butterfly_ref(wr, x.astype(jnp.float32),
                             transpose=transpose).astype(x.dtype)

    def run(x, w, c):
        y, vjp = jax.vjp(fwd, x, w)
        return (y, *vjp(c.astype(y.dtype)))

    return jax.jit(run)


def _want(x, w, c, transpose, jdt, interpret):
    return _reference(transpose, interpret)(
        jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(c))


def _close(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    frac = 1e-5 if dtype == "float32" else 0.05
    atol = frac * max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got, want, atol=atol, rtol=frac)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n,lead", CASES)
def test_forward_and_grads_match_reference_kernel(n, lead, transpose,
                                                  dtype):
    jdt, tdt = DTYPES[dtype]
    w, x, c = _inputs(n, lead, seed=n + len(lead))
    want, gx_w, gw_w = _want(x, w, c, transpose, jdt,
                             interpret=(n, lead) == CASES[0])

    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    _close(kb.butterfly_plain(tx, tw, transpose=transpose), want, dtype)
    got = kb.butterfly_apply(tx, tw, transpose=transpose, context="torch")
    assert got.shape == tx.shape and got.dtype == tdt
    _close(got, want, dtype)
    (got.float() * torch.from_numpy(c)).sum().backward()
    assert tx.grad.dtype == tdt and tw.grad.dtype == torch.float32
    _close(tx.grad, gx_w, dtype)
    _close(tw.grad, gw_w, dtype)


# the twin of the backward kernel's summation order: the file's cases, the
# encoder's width at 300 rows, and 37 rows over 4 blocks (no tile or block
# divides them); (n, leading shape, blocks)
TWIN_CASES = [(n, lead, 3) for n, lead in CASES] + [(1024, (300,), 4),
                                                     (1024, (37,), 4)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n,lead,blocks", TWIN_CASES)
def test_tiled_twin_matches_plain_and_reference(n, lead, blocks, transpose,
                                                dtype):
    """`butterfly_bwd_tiled_plain` (the kernel's summation order) against
    the plain autograd twin (dx bit for bit, dw at the file's tolerance)
    and against the reference's gradients (its kernel's `jax.vjp` in
    interpret mode at the smallest case, its plain reference's else)."""
    jdt, tdt = DTYPES[dtype]
    w, x, c = _inputs(n, lead, seed=n + len(lead) + 7)
    _, gx_w, gw_w = _want(x, w, c, transpose, jdt,
                          interpret=(n, lead) == CASES[0])
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w)
    g = torch.from_numpy(c).to(tdt)
    dx, dw = kb.butterfly_bwd_tiled_plain(tx, tw, g, transpose=transpose,
                                          blocks=blocks)
    pdx, pdw = kb.butterfly_bwd_plain(tx, tw, g, transpose=transpose)
    assert dx.dtype == tdt and dw.dtype == torch.float32
    assert torch.equal(dx, pdx)
    _close(dw, pdw, dtype)
    _close(dx, gx_w, dtype)
    _close(dw, gw_w, dtype)
    none, dw2 = kb.butterfly_bwd_tiled_plain(tx, tw, g, transpose=transpose,
                                             need_dx=False, blocks=blocks)
    assert none is None and torch.equal(dw2, dw)


@pytest.mark.parametrize("transpose", [False, True])
def test_backward_without_dx(transpose):
    """`need_dx=False` (the encoder's data needs no gradient) returns no dx
    and the same dw; autograd asks for it when x needs no gradient."""
    w, x, c = _inputs(64, (9,), seed=3)
    tw, tx, g = (torch.from_numpy(a) for a in (w, x, c))
    dx, dw = kb.butterfly_backward(tx, tw, g, transpose=transpose,
                                   context="torch")
    none, dw2 = kb.butterfly_backward(tx, tw, g, transpose=transpose,
                                      need_dx=False, context="torch")
    assert none is None and dx.shape == tx.shape
    torch.testing.assert_close(dw2, dw, rtol=0, atol=0)
    tw.requires_grad_()
    (kb.butterfly_apply(tx, tw, transpose=transpose) * g).sum().backward()
    torch.testing.assert_close(tw.grad, dw, rtol=1e-6, atol=1e-6)


def test_plain_route_launches_nothing():
    w, x, _ = _inputs(8, (4,), seed=5)
    before = (kb.butterfly_forward.launches, kb.butterfly_backward.launches)
    tw = torch.from_numpy(w).requires_grad_()
    kb.butterfly_apply(torch.from_numpy(x), tw).sum().backward()
    assert (kb.butterfly_forward.launches,
            kb.butterfly_backward.launches) == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kb.butterfly_apply(torch.from_numpy(x), tw, context="cuda")


def test_stage_applies_match_reference_count():
    """`stage_applies` is the reference's traced count of stage applications
    in `_butterfly_bwd_block`, for every segment size."""
    for n in (16, 256, 1024):
        p = int(np.log2(n))
        x = jnp.ones((2, n))
        w = jnp.ones((p, 2, n))
        for seg in sorted({1, 2, kb.default_segment(p), p}):
            with jkern.count_stage_applies() as applied:
                jkern._butterfly_bwd_block(x, w, x, p, transpose=False,
                                           segment=seg)
            assert kb.stage_applies(p, seg) == applied(), (n, seg)


@pytest.mark.parametrize("seg", [1, 2, 4, None])
def test_backward_stage_applies_bounded_for_all_segments(seg):
    """Port of the reference's CI gate: at n = 1024 every segment keeps the
    backward within p <= applications <= 3p (None: seg = p)."""
    p = 10
    assert p <= kb.stage_applies(p, seg or p) <= 3 * p


def test_backward_stage_applies_linear_bound():
    """At n = 4096 the default segment keeps the backward within 3p, and
    below the O(p²) full-prefix recompute."""
    p = 12
    assert kb.default_segment(p) == 4
    assert kb.stage_applies(p) <= 3 * p
    assert kb.stage_applies(p) < p * (p - 1) // 2 + p
