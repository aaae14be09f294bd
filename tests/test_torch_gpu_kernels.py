"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``gpu``: these skip without a CUDA device. This file imports no JAX,
so it runs on a machine that has only PyTorch; from the repo root:

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu_kernels.py

Tolerances are the reference's own: the sandwich kernel's float32 2e-4 and
bfloat16 5e-2, the paged kernel's float32 1e-5 and bfloat16 2e-2; the
sandwich backward's float32 1e-5 and bfloat16 8% of max|want|
(`tests/test_kernels_grad.py`); the butterfly kernels' float32 1e-5 and
bfloat16 5% of max|want|, forward and backward.
"""

import math

import pytest
import torch

from repro_torch.core import butterfly as bf
from repro_torch.core import layers as blayers
from repro_torch.kernels import butterfly as kb
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import sandwich as ks

pytestmark = pytest.mark.gpu

SANDWICH_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
PAGED_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run `pytest -m gpu` on the card)")
    # float32 plain twins must stay float32: no TF32 in their matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _sandwich_case(n_in, n_out, rows, dtype, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    spec = blayers.make_spec(gen, n_in, n_out, use_bias=False)
    p1 = int(math.log2(spec.pad_in))
    p2 = int(math.log2(spec.pad_out))
    args = dict(
        x=torch.randn(rows, n_in, generator=gen).to(dtype),
        b_in=torch.randn(p1, 2, spec.pad_in, generator=gen) / math.sqrt(2),
        core=torch.randn(spec.k_out, spec.k_in, generator=gen)
        / math.sqrt(spec.k_in),
        b_out=torch.randn(p2, 2, spec.pad_out, generator=gen) / math.sqrt(2),
        idx_in=torch.tensor(spec.idx_in, dtype=torch.int32),
        idx_out=torch.tensor(spec.idx_out, dtype=torch.int32))
    args = {k: v.to(dev) for k, v in args.items()}
    kw = dict(scale_in=spec.scale_in, scale_out=spec.scale_out, n_out=n_out)
    return args, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_in,n_out,rows", [
    (576, 1536, 8), (1536, 576, 128), (576, 49152, 8), (100, 36, 3),
    (64, 8192, 5), (32, 262144, 2)])
def test_sandwich_kernel_matches_plain(cuda, n_in, n_out, rows, dtype):
    args, kw = _sandwich_case(n_in, n_out, rows, dtype, cuda)
    before = ks.sandwich_forward.launches
    got = ks.sandwich_forward(**args, **kw, backend="cuda")
    want = ks.sandwich_forward(**args, **kw, backend="torch")
    torch.cuda.synchronize()
    assert ks.sandwich_forward.launches == before + 1
    assert got.shape == (rows, n_out) and got.dtype == dtype
    tol = SANDWICH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _assert_grad_close(got, want, dtype, what=""):
    """float32: atol = rtol = 1e-5 relative to max|want|; bfloat16: 8%."""
    frac = 1e-5 if dtype == torch.float32 else 0.08
    want = want.float()
    atol = frac * max(float(want.abs().max()), 1e-3)
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=frac,
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_in,n_out,rows", [
    (576, 1536, 256), (1536, 576, 256), (576, 49152, 256), (100, 36, 3),
    (64, 8192, 5), (48, 80, 7),
    # many rows per block: the row loops, uneven chunks, partial sums
    (576, 1536, 1000), (1536, 576, 8192), (576, 49152, 1000)])
def test_sandwich_bwd_kernel_matches_plain(cuda, n_in, n_out, rows, dtype):
    args, kw = _sandwich_case(n_in, n_out, rows, dtype, cuda)
    gen = torch.Generator().manual_seed(5)
    g = torch.randn(rows, n_out, generator=gen).to(cuda, dtype)
    before = ks.sandwich_backward.launches
    got = ks.sandwich_backward(**args, g=g, **kw, backend="cuda")
    again = ks.sandwich_backward(**args, g=g, **kw, backend="cuda")
    want = ks.sandwich_backward(**args, g=g, **kw, backend="torch")
    torch.cuda.synchronize()
    assert ks.sandwich_backward.launches == before + 2 * ks.BWD_KERNELS
    assert got[0].shape == (rows, n_in) and got[0].dtype == dtype
    for name, a, b, w in zip(("dx", "d b_in", "d core", "d b_out"), got,
                             again, want):
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, b), f"{name} differs between two launches"
        _assert_grad_close(a, w, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sandwich_fn_autograd_on_card(cuda, dtype):
    """Autograd through sandwich_forward on CUDA tensors reaches the
    backward kernel and gives every input its gradient."""
    args, kw = _sandwich_case(576, 1536, 32, dtype, cuda)
    leaves = {k: args[k].requires_grad_() for k in
              ("x", "b_in", "core", "b_out")}
    g = torch.randn(32, 1536, device=cuda).to(dtype)
    before = (ks.sandwich_forward.launches, ks.sandwich_backward.launches)
    out = ks.sandwich_forward(**args, **kw)
    out.backward(g)
    assert (ks.sandwich_forward.launches,
            ks.sandwich_backward.launches) == (before[0] + 1,
                                               before[1] + ks.BWD_KERNELS)
    want = ks.sandwich_bwd_plain(*(args[k].detach() for k in (
        "x", "b_in", "core", "b_out", "idx_in", "idx_out")), g, **kw)
    for (name, leaf), w in zip(leaves.items(), want):
        assert leaf.grad is not None, name
        _assert_grad_close(leaf.grad, w, dtype, name)


def _paged_case(dtype, dev, seed=0, B=8, KV=3, G=3, D=64, ps=16, P=32):
    gen = torch.Generator().manual_seed(seed)
    N = 1 + B * P
    k_pool = torch.randn(N, ps, KV, D, generator=gen)
    v_pool = torch.randn(N, ps, KV, D, generator=gen)
    ids = (torch.randperm(N - 1, generator=gen) + 1).reshape(B, P)
    cur = torch.tensor([0, 15, 16, 100, 255, 300, 511, 47][:B])
    k_pool[pa.TRASH_PAGE] = 1e4               # dirty trash page
    v_pool[pa.TRASH_PAGE] = -1e4
    for b in range(B):
        last = int(cur[b]) // ps
        off = int(cur[b]) % ps + 1
        k_pool[ids[b, last], off:] = 7e3     # stale rows past cur_pos
        v_pool[ids[b, last], off:] = -7e3
        for p in range(last + 1, P):         # NaN pages past cur_pos
            k_pool[ids[b, p]] = float("nan")
            v_pool[ids[b, p]] = float("nan")
    q = torch.randn(B, KV, G, D, generator=gen)
    return [t.to(dev) for t in (q.to(dtype), k_pool.to(dtype),
                                v_pool.to(dtype), ids.int(), cur.int())]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_matches_plain(cuda, dtype):
    args = _paged_case(dtype, cuda)
    before = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention(*args, backend="cuda")
    want = pa.paged_decode_attention(*args, backend="torch")
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == before + 1
    assert torch.isfinite(got).all()
    tol = PAGED_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_kernels_reject_bad_inputs(cuda):
    args, kw = _sandwich_case(576, 1536, 4, torch.float16, cuda)
    with pytest.raises(TypeError):
        ks.sandwich_forward(**args, **kw, backend="cuda")
    g = torch.zeros(4, 1536, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ks.sandwich_backward(**args, g=g, **kw, backend="cuda")
    q, k_pool, v_pool, ids, cur = _paged_case(torch.float32, cuda)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q, k_pool, v_pool, ids.long(), cur,
                                  backend="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("rows,n", [(1, 2), (11, 64), (300, 256),
                                    (1237, 1024), (400, 4096), (7, 8192)])
def test_butterfly_kernels_match_plain(cuda, rows, n, dtype, transpose):
    gen = torch.Generator().manual_seed(rows + n)
    w = bf.random_weights(gen, n).to(cuda)
    x = torch.randn(rows, n, generator=gen).to(cuda, dtype)
    g = torch.randn(rows, n, generator=gen).to(cuda, dtype)
    frac = 1e-5 if dtype == torch.float32 else 0.05
    before = (kb.butterfly_forward.launches, kb.butterfly_backward.launches)
    got = kb.butterfly_forward(x, w, transpose=transpose, backend="cuda")
    applied = torch.zeros(1, dtype=torch.int32, device=cuda)
    dx, dw = kb.butterfly_backward(x, w, g, transpose=transpose,
                                   backend="cuda", applied=applied)
    dx2, dw2 = kb.butterfly_backward(x, w, g, transpose=transpose,
                                     need_dx=False, backend="cuda")
    want = kb.butterfly_forward(x, w, transpose=transpose, backend="torch")
    pdx, pdw = kb.butterfly_backward(x, w, g, transpose=transpose,
                                     backend="torch")
    torch.cuda.synchronize()
    assert (kb.butterfly_forward.launches,
            kb.butterfly_backward.launches) == (
        before[0] + 1, before[1] + 2 * kb.BWD_KERNELS)
    assert got.dtype == dtype and dx.dtype == dtype and dx2 is None
    assert torch.equal(dw, dw2)
    p = int(math.log2(n))
    assert int(applied) == kb.stage_applies(p) <= 3 * p
    _assert_grad_close(got, want, dtype, "y")
    for name, a, b in (("dx", dx, pdx), ("dw", dw, pdw)):
        assert torch.isfinite(a).all(), name
        atol = frac * max(float(b.float().abs().max()), 1e-3)
        torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                   rtol=frac, msg=lambda m: f"{name}: {m}")


def test_butterfly_fn_autograd_on_card(cuda):
    """Autograd through butterfly_apply on CUDA tensors reaches both
    kernels, and skips dx where x needs no gradient."""
    gen = torch.Generator().manual_seed(3)
    w = bf.random_weights(gen, 1024).to(cuda).requires_grad_()
    x = torch.randn(50, 1024, generator=gen).to(cuda)
    c = torch.randn(50, 1024, generator=gen).to(cuda)
    before = (kb.butterfly_forward.launches, kb.butterfly_backward.launches)
    (kb.butterfly_apply(x, w) * c).sum().backward()
    assert (kb.butterfly_forward.launches,
            kb.butterfly_backward.launches) == (before[0] + 1,
                                                before[1] + kb.BWD_KERNELS)
    _, want = kb.butterfly_bwd_plain(x, w.detach(), c, need_dx=False)
    torch.testing.assert_close(w.grad, want, atol=1e-5 * float(
        want.abs().max()), rtol=1e-5)
    with pytest.raises(ValueError):
        kb.butterfly_forward(torch.zeros(2, 16384, device=cuda),
                             torch.zeros(14, 2, 16384, device=cuda))
