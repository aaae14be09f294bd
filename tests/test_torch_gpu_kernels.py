"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``gpu``: these skip without a CUDA device. This file imports no JAX,
so it runs on a machine that has only PyTorch; from the repo root:

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu_kernels.py

Tolerances are the reference's own: the sandwich kernel's float32 2e-4 and
bfloat16 5e-2 (its factor kernel's float32 1e-5), the paged kernel's
float32 1e-5 and bfloat16 2e-2; the sandwich backward's float32 1e-5 and
bfloat16 8% of max|want| (`tests/test_kernels_grad.py`; its factor-row VJP,
float32 in both dtypes, 1e-5); the butterfly
kernels' float32 1e-5 and bfloat16 5% of max|want|, forward and backward
(the learned sketch's training: losses rtol 1e-4), and at the
backward's tile edges bit for bit against the twins of their operations
and summation order;
the flash kernels' forward 1e-5 / 2e-2 of max|want|, lse 1e-5, gradients
1e-4 / 5e-2 (float32 sums in another order; bfloat16 rounds once at the
output), and in bfloat16 also each row of o and dq and each key's row of
dk and dv within 1% of its own norm.
"""

import math

import pytest
import torch

from repro_torch.core import butterfly as bf
from repro_torch.core import layers as blayers
from repro_torch.kernels import butterfly as kb
from repro_torch.kernels import flash as kf
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import sandwich as ks
from repro_torch.kernels import tuning

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


def _sandwich_case(n_in, n_out, rows, dtype, dev, seed=0, k=None):
    gen = torch.Generator().manual_seed(seed)
    spec = blayers.make_spec(gen, n_in, n_out, k_in=k, k_out=k,
                             use_bias=False)
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
    got = ks.sandwich_forward(**args, **kw, context="cuda")
    want = ks.sandwich_forward(**args, **kw, context="torch")
    torch.cuda.synchronize()
    assert ks.sandwich_forward.launches == before + ks.FWD_KERNELS
    assert got.shape == (rows, n_out) and got.dtype == dtype
    tol = SANDWICH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _layer_case(n_in, n_out, rows, dtype, dev, seed=0):
    """``_sandwich_case`` with the layer's own weights (FJLT butterflies,
    kaiming core: ``ButterflyLinear``'s init, as the model starts from)."""
    from repro_torch.nn import ButterflyLinear
    gen = torch.Generator().manual_seed(seed)
    spec = blayers.make_spec(gen, n_in, n_out, use_bias=False)
    layer = ButterflyLinear(spec, generator=gen)
    args = dict(x=torch.randn(rows, n_in, generator=gen).to(dtype),
                b_in=layer.b_in.detach(), core=layer.core.detach(),
                b_out=layer.b_out.detach(), idx_in=layer.idx_in,
                idx_out=layer.idx_out)
    args = {k: v.to(dev) for k, v in args.items()}
    kw = dict(scale_in=spec.scale_in, scale_out=spec.scale_out, n_out=n_out)
    return args, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,n_in,n_out,rows", [
    # the model's sites at the training run's rows, the layer's weights
    ("layer", 576, 1536, 8192), ("layer", 1536, 576, 8192),
    ("layer", 576, 49152, 8192),
    # mistral-large-123b's down site: n1 = 32,768, the widest input
    ("layer", 28672, 12288, 64),
    # row counts off the 64-row tile
    ("gaussian", 576, 1536, 1), ("gaussian", 576, 1536, 63),
    ("gaussian", 1536, 576, 65), ("gaussian", 576, 49152, 1000),
    ("gaussian", 100, 36, 65), ("gaussian", 48, 80, 63)])
def test_sandwich_kernel_rows_and_repeats(cuda, case, n_in, n_out, rows,
                                          dtype):
    """The forward at many rows and off-tile row counts against the plain
    twin; two launches give the same bits. The model's sites run on the
    layer's own weights, whose outputs are of order one: with Gaussian
    stage weights they reach the hundreds at these widths, and the float32
    summation order alone then moves a near-zero element past the
    elementwise 2e-4 (the twin sums stage by stage, the kernel as dot
    products)."""
    make = _layer_case if case == "layer" else _sandwich_case
    args, kw = make(n_in, n_out, rows, dtype, cuda)
    before = ks.sandwich_forward.launches
    got = ks.sandwich_forward(**args, **kw, context="cuda")
    again = ks.sandwich_forward(**args, **kw, context="cuda")
    want = ks.sandwich_forward(**args, **kw, context="torch")
    torch.cuda.synchronize()
    assert ks.sandwich_forward.launches == before + 2 * ks.FWD_KERNELS
    assert torch.equal(got, again), "two launches differ"
    tol = SANDWICH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_in,n_out,k", [
    (576, 1536, None), (1536, 576, None), (576, 49152, None), (100, 36, None),
    (64, 8192, None), (32, 262144, None), (48, 80, None), (128, 256, 64),
    (28672, 12288, None)])
def test_sandwich_factor_kernel_matches_plain(cuda, n_in, n_out, k, dtype):
    """The factor kernel through the wrapper's workspace: the float32
    factors against the plain twin (each entry a product of path weights,
    float32 1e-5 as the reference's tolerance), zeros in the padding, and
    for bfloat16 F_out's hi/lo pair, hi = bf16(F) and hi + lo within 2^-16
    of F."""
    gen = torch.Generator().manual_seed(n_in + n_out)
    spec = blayers.make_spec(gen, n_in, n_out, k_in=k, k_out=k,
                             use_bias=False)
    w_in = bf.random_weights(gen, spec.pad_in).to(cuda)
    w_out = bf.random_weights(gen, spec.pad_out).to(cuda)
    idx_in = torch.tensor(spec.idx_in, dtype=torch.int32, device=cuda)
    idx_out = torch.tensor(spec.idx_out, dtype=torch.int32, device=cuda)
    before = ks.sandwich_forward.launches
    f_in, f_out, hl = ks._factors_cuda(w_in, w_out, idx_in, idx_out, n_in,
                                       n_out, dtype)
    want = ks.sandwich_factors_plain(w_in, w_out, idx_in, idx_out, n_in,
                                     n_out, dtype)
    views = ks.sandwich_factors(w_in, w_out, idx_in, idx_out, n_in=n_in,
                                n_out=n_out, dtype=dtype, context="cuda")
    torch.cuda.synchronize()
    assert ks.sandwich_forward.launches == before + 2
    for f, w, v, (kk, n) in ((f_in, want[0], views[0], (spec.k_in, n_in)),
                             (f_out, want[1], views[1], (spec.k_out, n_out))):
        assert f.shape[0] % 16 == 0 and f.shape[1] % 128 == 0
        torch.testing.assert_close(f[:kk, :n], w, atol=1e-5, rtol=1e-5)
        assert torch.equal(v, f[:kk, :n])
        assert not f[kk:].any() and not f[:, n:].any()
    if dtype == torch.float32:
        assert hl is None
        return
    hi, lo = hl[0].float(), hl[1].float()
    assert torch.equal(hl[0], f_out.to(torch.bfloat16))
    assert bool(((hi + lo - f_out).abs() <= 2.0**-16 * f_out.abs()).all())


def _assert_grad_close(got, want, dtype, what=""):
    """float32: atol = rtol = 1e-5 relative to max|want|; bfloat16: 8%."""
    frac = 1e-5 if dtype == torch.float32 else 0.08
    want = want.float()
    atol = frac * max(float(want.abs().max()), 1e-3)
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=frac,
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_in,n_out,rows,k", [
    (576, 1536, 256, None), (1536, 576, 256, None), (576, 49152, 256, None),
    (100, 36, 3, None), (64, 8192, 5, None), (48, 80, 7, None),
    # many row tiles and row splits of the column kernel, ragged tiles
    (576, 1536, 1000, None), (1536, 576, 8192, None),
    (576, 49152, 1000, None),
    # bench_backward's widest (k = 13), a core of 64 x 64
    (8192, 8192, 64, None), (128, 256, 65, 64),
    # n1 = 32,768 (mistral-large-123b's down) and n2 = 262,144: the widest
    # factor rows, whose VJP runs in device memory
    (28672, 12288, 64, None), (32, 262144, 2, None)])
def test_sandwich_bwd_kernel_matches_plain(cuda, n_in, n_out, rows, k,
                                           dtype):
    """The backward's six launches against ``sandwich_bwd_plain``: the
    model's weights where the widths pass 8192 (Gaussian stage weights grow
    outputs to the hundreds there), Gaussian ones elsewhere; two launches
    give the same bits."""
    if max(n_in, n_out) > 8192:
        args, kw = _layer_case(n_in, n_out, rows, dtype, cuda)
    else:
        args, kw = _sandwich_case(n_in, n_out, rows, dtype, cuda, k=k)
    gen = torch.Generator().manual_seed(5)
    g = torch.randn(rows, n_out, generator=gen).to(cuda, dtype)
    before = ks.sandwich_backward.launches
    got = ks.sandwich_backward(**args, g=g, **kw, context="cuda")
    again = ks.sandwich_backward(**args, g=g, **kw, context="cuda")
    want = ks.sandwich_backward(**args, g=g, **kw, context="torch")
    torch.cuda.synchronize()
    assert ks.sandwich_backward.launches == before + 2 * ks.BWD_KERNELS
    assert got[0].shape == (rows, n_in) and got[0].dtype == dtype
    for name, a, b, w in zip(("dx", "d b_in", "d core", "d b_out"), got,
                             again, want):
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, b), f"{name} differs between two launches"
        _assert_grad_close(a, w, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_in,n_out,k", [
    (576, 1536, None), (1536, 576, None), (576, 49152, None), (48, 80, None),
    (128, 256, 64), (28672, 12288, None), (32, 262144, None)])
def test_sandwich_factors_vjp_kernel_matches_plain(cuda, n_in, n_out, k,
                                                   dtype):
    """The factor-row VJP and its reduction alone against autograd through
    ``sandwich_factors_plain``, for Gaussian cotangents: float32 1e-5 of
    max|want| in both dtypes (the weights are rounded, the sums float32),
    two launches bit-identical, two counts each."""
    from repro_torch.nn import ButterflyLinear
    gen = torch.Generator().manual_seed(n_in + 3 * n_out)
    spec = blayers.make_spec(gen, n_in, n_out, k_in=k, k_out=k,
                             use_bias=False)
    layer = ButterflyLinear(spec, generator=gen).to(cuda)
    d_f_in = torch.randn(spec.k_in, n_in, generator=gen).to(cuda)
    d_f_out = torch.randn(spec.k_out, n_out, generator=gen).to(cuda)
    w = (layer.b_in.detach(), layer.b_out.detach(), layer.idx_in,
         layer.idx_out, d_f_in, d_f_out)
    before = ks.sandwich_backward.launches
    got = ks.sandwich_factors_vjp(*w, dtype=dtype, context="cuda")
    again = ks.sandwich_factors_vjp(*w, dtype=dtype, context="cuda")
    want = ks.sandwich_factors_vjp(*w, dtype=dtype, context="torch")
    torch.cuda.synchronize()
    assert ks.sandwich_backward.launches == before + 4
    for name, a, b, ww in zip(("d b_in", "d b_out"), got, again, want):
        assert torch.equal(a, b), f"{name} differs between two launches"
        _assert_grad_close(a, ww, torch.float32, name)


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
            ks.sandwich_backward.launches) == (before[0] + ks.FWD_KERNELS,
                                               before[1] + ks.BWD_KERNELS)
    want = ks.sandwich_bwd_plain(*(args[k].detach() for k in (
        "x", "b_in", "core", "b_out", "idx_in", "idx_out")), g, **kw)
    for (name, leaf), w in zip(leaves.items(), want):
        assert leaf.grad is not None, name
        _assert_grad_close(leaf.grad, w, dtype, name)


# cur_pos per slot: the serving engine's shape (max_len 512), a long one
# (2048, SmolLM-135M's context), and positions at the runs' boundaries
# (runs of 64 positions: 63 ends one, 64 starts the next)
PAGED_CURS = {"serve": ((0, 15, 16, 100, 255, 300, 511, 47), 32),
              "long": ((2047, 2000, 1500, 1024, 777, 511, 16, 0), 128),
              "boundaries": ((63, 64, 127, 128, 191, 0, 1, 510), 32)}


def _paged_case(dtype, dev, seed=0, B=8, KV=3, G=3, D=64, ps=16, P=32,
                cur=PAGED_CURS["serve"][0]):
    gen = torch.Generator().manual_seed(seed)
    N = 1 + B * P
    k_pool = torch.randn(N, ps, KV, D, generator=gen)
    v_pool = torch.randn(N, ps, KV, D, generator=gen)
    ids = (torch.randperm(N - 1, generator=gen) + 1).reshape(B, P)
    cur = torch.tensor(cur[:B])
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
@pytest.mark.parametrize("case", sorted(PAGED_CURS))
def test_paged_kernel_matches_plain(cuda, dtype, case):
    """The split kernel and its combine against the oracle and the split's
    plain twin, with a dirty trash page, stale rows and NaN pages past
    cur_pos; two launches bit-identical."""
    cur, P = PAGED_CURS[case]
    args = _paged_case(dtype, cuda, P=P, cur=cur)
    before = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention(*args, context="cuda")
    again = pa.paged_decode_attention(*args, context="cuda")
    want = pa.paged_decode_attention(*args, context="torch")
    split = pa.paged_decode_split_plain(*args, pa.pages_per_split(16, P))
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == before + 2 * pa.PAGED_KERNELS
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    tol = PAGED_TOL[dtype]
    for w in (want, split):
        torch.testing.assert_close(got.float(), w.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,D,ps", [(2, 1, 8, 16), (1, 4, 16, 4),
                                       (2, 2, 128, 8), (1, 16, 256, 32),
                                       (3, 7, 72, 64)])
def test_paged_kernel_shapes(cuda, dtype, KV, G, D, ps):
    """Head dims 8..256, groups up to 16 and pages of 4 to 64 positions
    (runs of one to 16 pages); a slot with cur_pos -1 gets zeros."""
    cur = (0, 3, 4, 63, 64, 200, 255, -1)
    args = _paged_case(dtype, cuda, KV=KV, G=G, D=D, ps=ps, P=256 // ps,
                       cur=cur)
    got = pa.paged_decode_attention(*args, context="cuda")
    want = pa.paged_decode_attention(*args, context="torch")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and not got[-1].any()
    tol = PAGED_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_kernels_reject_bad_inputs(cuda):
    args, kw = _sandwich_case(576, 1536, 4, torch.float16, cuda)
    with pytest.raises(TypeError):
        ks.sandwich_forward(**args, **kw, context="cuda")
    g = torch.zeros(4, 1536, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ks.sandwich_backward(**args, g=g, **kw, context="cuda")
    q, k_pool, v_pool, ids, cur = _paged_case(torch.float32, cuda)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q, k_pool, v_pool, ids.long(), cur,
                                  context="cuda")
    before = pa.paged_decode_attention.launches
    for bad in (dict(D=12), dict(G=17), dict(D=264)):
        args = _paged_case(torch.float32, cuda, **bad)
        with pytest.raises(ValueError, match="head dims"):
            pa.paged_decode_attention(*args, context="cuda")
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)                       # contiguous, 4 bytes off
    with pytest.raises(ValueError, match="aligned"):
        pa.paged_decode_attention(shifted, k_pool, v_pool, ids, cur,
                                  context="cuda")
    assert pa.paged_decode_attention.launches == before
    # past the widths the kernels take: ValueError naming the limit, before
    # any launch
    before = (ks.sandwich_forward.launches, ks.sandwich_backward.launches,
              kb.butterfly_forward.launches, kb.butterfly_backward.launches)
    for n_in, n_out, k in ((40000, 64, None), (64, 300000, None),
                           (128, 256, 65)):
        args, kw = _sandwich_case(n_in, n_out, 2, torch.float32, cuda, k=k)
        g = torch.zeros(2, n_out, device=cuda)
        for call in (lambda: ks.sandwich_forward(**args, **kw,
                                                 context="cuda"),
                     lambda: ks.sandwich_backward(**args, g=g, **kw,
                                                  context="cuda"),
                     lambda: ks.sandwich_factors(
                         args["b_in"], args["b_out"], args["idx_in"],
                         args["idx_out"], n_in=n_in, n_out=n_out,
                         dtype=torch.float32, context="cuda")):
            with pytest.raises(ValueError, match="n1 <= 32768"):
                call()
    x = torch.zeros(2, 65536, device=cuda)
    w = torch.zeros(16, 2, 65536, device=cuda)
    with pytest.raises(ValueError, match="32768"):
        kb.butterfly_forward(x, w, context="cuda")
    with pytest.raises(ValueError, match="32768"):
        kb.butterfly_backward(x, w, x, context="cuda")
    assert before == (ks.sandwich_forward.launches,
                      ks.sandwich_backward.launches,
                      kb.butterfly_forward.launches,
                      kb.butterfly_backward.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("rows,n", [(1, 2), (11, 64), (300, 256),
                                    (1237, 1024), (400, 4096), (7, 8192),
                                    (3, 16384), (64, 32768),
                                    # the learned sketch's step: 6 matrices
                                    # of 768 columns, n 1024
                                    (4608, 1024)])
def test_butterfly_kernels_match_plain(cuda, rows, n, dtype, transpose):
    gen = torch.Generator().manual_seed(rows + n)
    w = bf.random_weights(gen, n).to(cuda)
    x = torch.randn(rows, n, generator=gen).to(cuda, dtype)
    g = torch.randn(rows, n, generator=gen).to(cuda, dtype)
    frac = 1e-5 if dtype == torch.float32 else 0.05
    before = (kb.butterfly_forward.launches, kb.butterfly_backward.launches)
    got = kb.butterfly_forward(x, w, transpose=transpose, context="cuda")
    applied = torch.zeros(1, dtype=torch.int32, device=cuda)
    dx, dw = kb.butterfly_backward(x, w, g, transpose=transpose,
                                   context="cuda", applied=applied)
    dx2, dw2 = kb.butterfly_backward(x, w, g, transpose=transpose,
                                     need_dx=False, context="cuda")
    want = kb.butterfly_forward(x, w, transpose=transpose, context="torch")
    pdx, pdw = kb.butterfly_backward(x, w, g, transpose=transpose,
                                     context="torch")
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
        kb.butterfly_forward(torch.zeros(2, 65536, device=cuda),
                             torch.zeros(16, 2, 65536, device=cuda))


def test_sketch_training_on_card(cuda):
    """The learned sketch trains through ``ButterflyFn``: one forward and
    one backward call (no dx) a step; its losses, and the loss its learned
    weights give, within rtol 1e-4 of the plain route's on the same
    batches (Adam turns a gradient at the rounding floor into a full step,
    so weights are compared through their loss)."""
    from repro_torch.core import sketch
    gen = torch.Generator().manual_seed(5)
    spec = sketch.make_spec(gen, 100, 12, 4)
    w0 = bf.fjlt_weights(gen, spec.pad_n)
    Xs = torch.randn(8, 100, 40, generator=gen)
    before = (kb.butterfly_forward.launches, kb.butterfly_backward.launches)
    got, hist = sketch.train_butterfly_sketch(spec, None, Xs.to(cuda), 3,
                                              batch=3, log_every=1, w0=w0,
                                              device=cuda)
    assert (kb.butterfly_forward.launches,
            kb.butterfly_backward.launches) == (before[0] + 3,
                                                before[1] + 3 * kb.BWD_KERNELS)
    want, want_h = sketch.train_butterfly_sketch(
        spec, None, Xs.to(cuda), 3, batch=3, log_every=1, w0=w0,
        device=cuda, context="torch")
    torch.testing.assert_close(torch.tensor(hist), torch.tensor(want_h),
                               rtol=1e-4, atol=0)
    X = Xs[:1].to(cuda)
    losses = [float(sketch.reconstruction_loss(X, sketch.butterfly_sketch(
        spec, v, X, context="torch"), 4)) for v in (got, want)]
    assert math.isclose(*losses, rel_tol=1e-4), losses


def test_sketch_loss_of_a_non_finite_sketch_is_nan_on_card(cuda):
    """A sketch with a non-finite entry gives a NaN loss for its matrix on
    the card, as the reference's SVD does (the CPU's SVD raises instead,
    and ``reconstruction_loss`` turns that into NaN)."""
    from repro_torch.core import sketch
    gen = torch.Generator().manual_seed(6)
    X = torch.randn(2, 20, 12, generator=gen).to(cuda)
    Xt = torch.randn(2, 4, 12, generator=gen).to(cuda)
    Xt[1, 0, 0] = float("nan")
    assert torch.isnan(sketch.reconstruction_loss(X, Xt, 2)[1])


# Row counts at the backward's tile and block edges: R rows fill every
# block of a full grid with one whole tile of its plan (R = blocks x tile
# rows, from the plan for many rows), R - 1 and R + 1 about it, and fewer
# rows than the card has SMs.
BFLY_EDGES = ("R-1", "R", "R+1", "few")


def _edge_rows(cuda, n, edge):
    blocks, _, _, tile = tuning.butterfly_bwd_plan(1 << 20, n, False,
                                                   torch.float32,
                                                   cuda.index or 0)
    r = blocks * tile
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    return {"R-1": r - 1, "R": r, "R+1": r + 1, "few": sms // 2 + 1}[edge]


@pytest.mark.parametrize("edge", BFLY_EDGES)
@pytest.mark.parametrize("n", [1024, 2048, 32768])
def test_butterfly_kernels_bits_at_tile_edges(cuda, n, edge):
    """At the backward's tile and block edges, both directions and dtypes:
    the forward and dx have the plain twins' bits (the same products and
    sums), and dw the bits of ``butterfly_bwd_tiled_plain`` for the blocks
    of the kernel's plan (its summation order); dw within the file's
    tolerance of the plain autograd twin."""
    rows = _edge_rows(cuda, n, edge)
    for transpose in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator().manual_seed(rows + n + transpose)
            w = bf.random_weights(gen, n).to(cuda)
            x = torch.randn(rows, n, generator=gen).to(cuda, dtype)
            g = torch.randn(rows, n, generator=gen).to(cuda, dtype)
            what = f"{rows}x{n} transpose={transpose} {dtype}"
            got = kb.butterfly_forward(x, w, transpose=transpose,
                                       context="cuda")
            dx, dw = kb.butterfly_backward(x, w, g, transpose=transpose,
                                           context="cuda")
            blocks = tuning.butterfly_bwd_plan(rows, n, transpose, dtype,
                                               cuda.index or 0)[0]
            tdx, tdw = kb.butterfly_bwd_tiled_plain(
                x.cpu(), w.cpu(), g.cpu(), transpose=transpose,
                blocks=blocks)
            want = kb.butterfly_plain(x, w, transpose=transpose)
            _, pdw = kb.butterfly_bwd_plain(x, w, g, transpose=transpose,
                                            need_dx=False)
            torch.cuda.synchronize()
            assert torch.equal(got, want), what
            assert torch.equal(dx.cpu(), tdx), what
            assert torch.equal(dw.cpu(), tdw), what
            frac = 1e-5 if dtype == torch.float32 else 0.05
            torch.testing.assert_close(
                dw, pdw, rtol=frac, atol=frac * float(pdw.abs().max()),
                msg=lambda m: f"{what} dw: {m}")


@pytest.mark.parametrize("rows,n,dtype", [
    (300, 1024, torch.float32), (70000, 1024, torch.bfloat16),
    (257, 8, torch.float32), (1237, 2048, torch.float32),
    (9, 16384, torch.bfloat16)])
def test_butterfly_block_b_is_honoured_or_refused(cuda, rows, n, dtype):
    """The tile rule on the card: every tile rows the rule takes for the
    backward replaces the plan's in the launch (``butterfly_bwd_plan``)
    with the plan's blocks, and gives the default's bits, dx and dw; the
    forward's compiled rows a block likewise; a value the kernels do not
    take raises before any launch. The launched tile and where it lives
    are the rule's model of the plan."""
    from repro_torch.kernels.context import ExecutionContext
    gen = torch.Generator().manual_seed(n + rows)
    w = bf.random_weights(gen, n).to(cuda)
    x = torch.randn(rows, n, generator=gen).to(cuda, dtype)
    g = torch.randn(rows, n, generator=gen).to(cuda, dtype)
    y = kb.butterfly_forward(x, w, context="cuda")
    base = kb.butterfly_backward(x, w, g, context="cuda")
    fwd = tuning.choice("butterfly", n, dtype, "fwd")
    bwd = tuning.choice("butterfly", n, dtype, "bwd")
    plan = tuning.butterfly_bwd_plan(rows, n, False, dtype, cuda.index or 0)
    assert plan[3] in bwd.takes
    assert bool(plan[2]) == bwd.tiles_in_device_memory
    ctx = ExecutionContext(backend="cuda", block_b=fwd.block_b)
    assert torch.equal(kb.butterfly_forward(x, w, context=ctx), y)
    for b in bwd.takes[:4] + bwd.takes[-2:]:
        got = tuning.butterfly_bwd_plan(rows, n, False, dtype,
                                        cuda.index or 0, b)
        assert got[0] == plan[0] and got[3] == b
        dx, dw = kb.butterfly_backward(
            x, w, g, context=ExecutionContext(backend="cuda", block_b=b))
        torch.cuda.synchronize()
        assert torch.equal(dx, base[0]) and torch.equal(dw, base[1]), b
    before = (kb.butterfly_forward.launches, kb.butterfly_backward.launches)
    for call, b in ((kb.butterfly_backward, bwd.takes[-1] + 1),
                    (kb.butterfly_forward, fwd.block_b + 1)):
        args = (x, w, g) if call is kb.butterfly_backward else (x, w)
        with pytest.raises(ValueError, match="takes block_b"):
            call(*args, context=ExecutionContext(backend="cuda", block_b=b))
    assert (kb.butterfly_forward.launches,
            kb.butterfly_backward.launches) == before


def test_sandwich_block_b_takes_the_compiled_tiles(cuda):
    """The sandwich's row kernels own 64 rows forward and 32 backward: the
    forward under block_b = 64 gives the default's bits, anything else is
    refused before any launch."""
    from repro_torch.kernels.context import ExecutionContext
    gen = torch.Generator().manual_seed(5)
    spec = blayers.make_spec(gen, 576, 1536)
    from repro_torch.nn import ButterflyLinear
    layer = ButterflyLinear(spec, generator=gen).to(cuda)
    x = torch.randn(8, 576, generator=gen).to(cuda, torch.bfloat16)
    kw = dict(scale_in=spec.scale_in, scale_out=spec.scale_out,
              n_out=spec.n_out)
    args = (layer.b_in, layer.core, layer.b_out, layer.idx_in,
            layer.idx_out)
    with torch.no_grad():
        base = ks.sandwich_forward(x, *args, **kw, context="cuda")
        got = ks.sandwich_forward(x, *args, **kw, context=ExecutionContext(
            backend="cuda", block_b=64))
        assert torch.equal(got, base)
        before = ks.sandwich_forward.launches
        with pytest.raises(ValueError, match="block_b 64"):
            ks.sandwich_forward(x, *args, **kw, context=ExecutionContext(
                backend="cuda", block_b=32))
        assert ks.sandwich_forward.launches == before
    assert any(k.startswith("sandwich/fwd/n2048/bfloat16")
               for k in tuning.cache_entries())


@pytest.mark.parametrize("rows,n,transpose,dtype", [
    (70000, 1024, False, torch.float32), (257, 8, True, torch.float32),
    (9, 16384, False, torch.bfloat16)])
def test_butterfly_backward_takes_the_default_segment(cuda, rows, n,
                                                      transpose, dtype):
    """The execution context's segment on the card: ⌈√p⌉ named explicitly
    gives the unset field's bits and ``stage_applies(p)`` stage
    applications; 1 and p are refused before any launch, naming ROADMAP
    item 7."""
    from repro_torch.kernels.context import ExecutionContext
    p = n.bit_length() - 1
    gen = torch.Generator().manual_seed(n + rows)
    w = bf.random_weights(gen, n).to(cuda)
    x = torch.randn(rows, n, generator=gen).to(cuda, dtype)
    g = torch.randn(rows, n, generator=gen).to(cuda, dtype)
    base = kb.butterfly_backward(x, w, g, transpose=transpose,
                                 context="cuda")
    applied = torch.zeros(1, dtype=torch.int32, device=cuda)
    dx, dw = kb.butterfly_backward(
        x, w, g, transpose=transpose, applied=applied,
        context=ExecutionContext(backend="cuda",
                                 segment=kb.default_segment(p)))
    torch.cuda.synchronize()
    assert int(applied) == kb.stage_applies(p)
    assert torch.equal(dx, base[0]) and torch.equal(dw, base[1])
    before = kb.butterfly_backward.launches
    for seg in (1, p):
        with pytest.raises(ValueError, match="item 7"):
            kb.butterfly_backward(
                x, w, g, transpose=transpose,
                context=ExecutionContext(backend="cuda", segment=seg))
    assert kb.butterfly_backward.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n", [(70000, 1024), (5, 1024), (1237, 2048),
                                    (64, 32768)])
def test_butterfly_backward_repeats_and_counts(cuda, rows, n, dtype):
    """Two backward calls give the same bits, with and without dx; each
    call adds BWD_KERNELS to the backward's count and each forward 1."""
    gen = torch.Generator().manual_seed(rows)
    w = bf.random_weights(gen, n).to(cuda)
    x = torch.randn(rows, n, generator=gen).to(cuda, dtype)
    g = torch.randn(rows, n, generator=gen).to(cuda, dtype)
    before = (kb.butterfly_forward.launches, kb.butterfly_backward.launches)
    y1 = kb.butterfly_forward(x, w, context="cuda")
    y2 = kb.butterfly_forward(x, w, context="cuda")
    dx1, dw1 = kb.butterfly_backward(x, w, g, context="cuda")
    dx2, dw2 = kb.butterfly_backward(x, w, g, context="cuda")
    none, dw3 = kb.butterfly_backward(x, w, g, need_dx=False, context="cuda")
    torch.cuda.synchronize()
    assert (kb.butterfly_forward.launches,
            kb.butterfly_backward.launches) == (
        before[0] + 2, before[1] + 3 * kb.BWD_KERNELS)
    assert torch.equal(y1, y2) and torch.equal(dx1, dx2)
    assert torch.equal(dw1, dw2) and torch.equal(dw1, dw3) and none is None


FLASH_FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
FLASH_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


FLASH_ROW_TOL = 1e-2


# dq and dk are sums of terms p·(dp − Δ) that cancel. Where the exact
# gradient is 0 (S = 1: one key a row, p = 1 and dp = Δ; the reference's
# jax.grad gives exactly 0) the twin and the kernel each return float32
# rounding noise of those terms (on the H100 at S = 1, D = 8: ~0.7 and
# ~0.5 unit roundoffs of the largest), which no fraction of max|want| can
# hold. So dq's and dk's absolute tolerance is at least CANCEL_ULPS unit
# roundoffs of the largest term summed into an entry; at every other
# shape of these tests that floor stays below FLASH_GRAD_TOL's (at most
# 0.36 of it), so it changes nothing there.
CANCEL_ULPS = 16


def cancel_floor(q, k, v, do, lse, delta, causal=True, window=0):
    """Absolute floors for (dq, dk, dv): CANCEL_ULPS float32 unit roundoffs
    of the largest Σ p·(|dO|·|v|ᵀ + |Δ|)·|k| (dq) or its transpose against
    |q| (dk), scaled by D^-0.5 as the gradients are; 0 for dv, a sum of
    terms that do not cancel."""
    B, H, S, D = q.shape
    _, p = kf._probs(q, k, lse, causal, window)
    mag = p * (do.float().abs() @ v.float().abs().transpose(-1, -2)
               + delta.abs().reshape(B, H, S, 1))
    unit = CANCEL_ULPS * 2.0 ** -24 * kf._scale(D)
    return (unit * float((mag @ k.float().abs()).max()),
            unit * float((mag.transpose(-1, -2) @ q.float().abs()).max()),
            0.0)


def _close_to_max(got, want, frac, what, floor=0.0):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), what
    atol = max(frac * max(float(want.abs().max()), 1e-3), floor)
    torch.testing.assert_close(got, want, atol=atol, rtol=frac,
                               msg=lambda m: f"{what}: {m}")


def _rows_close(got, want, what):
    """Every row (last dim) within FLASH_ROW_TOL of its own norm, plus
    1e-3 of the largest row's (at least 1e-3, as _close_to_max floors it):
    no row passes for being small."""
    err = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1)
    scale = ref + 1e-3 * max(float(ref.max()), 1e-3)
    worst = float((err / scale).max())
    assert worst <= FLASH_ROW_TOL, f"{what}: a row off by {worst:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0), (False, 40)])
@pytest.mark.parametrize("B,H,S,D", [(1, 2, 1, 8), (2, 3, 77, 8),
                                     (1, 2, 200, 64), (2, 1, 130, 128),
                                     (1, 2, 100, 256), (1, 1, 65, 136)])
def test_flash_kernels_match_plain(cuda, B, H, S, D, causal, window, dtype):
    gen = torch.Generator().manual_seed(S + D)
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen).to(cuda, dtype)
                   for _ in range(4))
    kw = dict(causal=causal, window=window)
    before = (kf.flash_forward.launches, kf.flash_backward.launches)
    out, lse = kf.flash_forward(q, k, v, context="cuda", **kw)
    pout, plse = kf.flash_forward(q, k, v, context="torch", **kw)
    got = kf.flash_backward(q, k, v, pout, plse, do, context="cuda", **kw)
    again = kf.flash_backward(q, k, v, pout, plse, do, context="cuda", **kw)
    want = kf.flash_backward(q, k, v, pout, plse, do, context="torch", **kw)
    torch.cuda.synchronize()
    assert (kf.flash_forward.launches, kf.flash_backward.launches) == (
        before[0] + 1, before[1] + 2 * kf.BWD_KERNELS)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert lse.shape == (B * H, S)
    _close_to_max(out, pout, FLASH_FWD_TOL[dtype], "o")
    _close_to_max(lse, plse, 1e-5, "lse")
    if dtype == torch.bfloat16:
        _rows_close(out, pout, "o")
    floors = cancel_floor(q, k, v, do, plse, kf.row_delta(pout, do), **kw)
    for name, a, b, w, floor in zip(("dq", "dk", "dv"), got, again, want,
                                    floors):
        assert torch.equal(a, b), f"{name} differs between two launches"
        assert a.dtype == dtype
        _close_to_max(a, w, FLASH_GRAD_TOL[dtype], name, floor)
        if dtype == torch.bfloat16:
            _rows_close(a, w, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100),
                                           (False, 0), (False, 100)])
@pytest.mark.parametrize("D", [8, 24, 64, 128, 192, 256])
@pytest.mark.parametrize("S", [1, 63, 65, 300])
def test_flash_forward_tensor_cores(cuda, S, D, causal, window, dtype):
    """The forward kernel (mma tiles of 64 rows, bfloat16 with p as a hi/lo
    pair, float32 in 3xTF32) against its plain twin: S around one tile and
    ragged, head dims whose k is zero-padded (8, 24) up to the widest,
    windows and non-causal sweeps; one launch a call, bit-identical."""
    gen = torch.Generator().manual_seed(S * D)
    q, k, v = (torch.randn(2, 3, S, D, generator=gen).to(cuda, dtype)
               for _ in range(3))
    kw = dict(causal=causal, window=window)
    before = kf.flash_forward.launches
    out, lse = kf.flash_forward(q, k, v, context="cuda", **kw)
    again, _ = kf.flash_forward(q, k, v, context="cuda", **kw)
    pout, plse = kf.flash_forward(q, k, v, context="torch", **kw)
    torch.cuda.synchronize()
    assert kf.flash_forward.launches == before + 2
    assert torch.equal(out, again)
    _close_to_max(out, pout, FLASH_FWD_TOL[dtype], "o")
    _close_to_max(lse, plse, 1e-5, "lse")
    if dtype == torch.bfloat16:
        _rows_close(out, pout, "o")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100),
                                           (False, 0), (False, 100)])
@pytest.mark.parametrize("D", [8, 64, 128, 192, 256])
@pytest.mark.parametrize("S", [17, 63, 65, 300])
def test_flash_backward_tensor_cores(cuda, S, D, causal, window, dtype):
    """The dq and dkv kernels (mma tiles, p and ds as hi/lo bfloat16 pairs,
    float32 in 3xTF32; 32-row blocks above D = 128) against their plain
    twins: S inside one tile, around one tile and ragged over several, a
    zero-padded head dim (8) up to the widest, windows and non-causal
    sweeps; two launches a call, bit-identical. (One key a row, S = 1, is
    test_flash_kernels_match_plain's: there the exact dq and dk are 0 and
    both routes return rounding noise, held to cancel_floor.)"""
    gen = torch.Generator().manual_seed(S * D + 1)
    q, k, v, do = (torch.randn(2, 3, S, D, generator=gen).to(cuda, dtype)
                   for _ in range(4))
    kw = dict(causal=causal, window=window)
    out, lse = kf.flash_forward(q, k, v, context="torch", **kw)
    before = kf.flash_backward.launches
    got = kf.flash_backward(q, k, v, out, lse, do, context="cuda", **kw)
    again = kf.flash_backward(q, k, v, out, lse, do, context="cuda", **kw)
    torch.cuda.synchronize()
    assert kf.flash_backward.launches == before + 2 * kf.BWD_KERNELS
    want = kf.flash_backward(q, k, v, out, lse, do, context="torch", **kw)
    floors = cancel_floor(q, k, v, do, lse, kf.row_delta(out, do), **kw)
    for name, a, b, w, floor in zip(("dq", "dk", "dv"), got, again, want,
                                    floors):
        assert torch.equal(a, b), f"{name} differs between two launches"
        assert a.dtype == dtype and a.shape == q.shape
        _close_to_max(a, w, FLASH_GRAD_TOL[dtype], name, floor)
        if dtype == torch.bfloat16:
            _rows_close(a, w, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("where", ["q", "do"])
def test_flash_kernels_keep_nan(cuda, where, causal, dtype):
    """A NaN planted in q or dO (float32: 0x7fffffff, the NaN the card's
    arithmetic makes, as inf − inf) comes out of the forward (q) and the dq
    and dkv kernels as NaN exactly where the plain twins give NaN, and the
    rest agrees: 3xTF32's split keeps a NaN a NaN. It sits at the last
    query row of one head, which every key block's sweep reaches (causal
    or not), so the kernels' 0·NaN products match the twins' dense ones."""
    gen = torch.Generator().manual_seed(31)
    q, k, v, do = (torch.randn(2, 3, 130, 64, generator=gen).to(cuda, dtype)
                   for _ in range(4))
    kw = dict(causal=causal)
    out, lse = kf.flash_forward(q, k, v, context="torch", **kw)
    t = q if where == "q" else do
    if dtype == torch.float32:
        t.view(torch.int32)[1, 2, -1, 5] = 0x7fffffff
    else:
        t[1, 2, -1, 5] = float("nan")
    delta = kf.row_delta(out, do)
    got = [kf.dq_cuda(q, k, v, do, lse, delta, **kw),
           *kf.dkv_cuda(q, k, v, do, lse, delta, **kw)]
    want = [kf.flash_dq_plain(q, k, v, do, lse, delta, **kw),
            *kf.flash_dkv_plain(q, k, v, do, lse, delta, **kw)]
    names = ["dq", "dk", "dv"]
    if where == "q":
        names += ["o", "lse"]
        got += kf.flash_forward(q, k, v, context="cuda", **kw)
        want += kf.flash_forward(q, k, v, context="torch", **kw)
    torch.cuda.synchronize()
    for name, a, w in zip(names, got, want):
        nan = torch.isnan(w)
        assert nan.any(), f"{name}: the twin gives no NaN"
        assert torch.equal(torch.isnan(a), nan), f"{name}: NaN elsewhere"
        tol = (FLASH_GRAD_TOL if name[0] == "d" else FLASH_FWD_TOL)[dtype]
        _close_to_max(a[~nan], w[~nan], tol, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fn_autograd_on_card(cuda, dtype):
    """Autograd through flash_attention on CUDA tensors runs one forward
    and two backward launches and gives the plain twins' gradients."""
    gen = torch.Generator().manual_seed(9)
    q, k, v, c = (torch.randn(2, 3, 150, 64, generator=gen).to(cuda, dtype)
                  for _ in range(4))
    grads = {}
    for backend in ("cuda", "torch"):
        before = (kf.flash_forward.launches, kf.flash_backward.launches)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = kf.flash_attention(*leaves, window=64, context=backend)
        grads[backend] = torch.autograd.grad(
            (c.float() * out.float()).sum(), leaves)
        rose = (kf.flash_forward.launches - before[0],
                kf.flash_backward.launches - before[1])
        assert rose == ((1, kf.BWD_KERNELS) if backend == "cuda" else (0, 0))
    for name, a, b in zip(("dq", "dk", "dv"), grads["cuda"],
                          grads["torch"]):
        _close_to_max(a, b, FLASH_GRAD_TOL[dtype], name)
        if dtype == torch.bfloat16:
            _rows_close(a, b, name)


@pytest.mark.parametrize("D,dtype,rows", [
    (8, torch.float32, (64, 64)), (64, torch.float32, (64, 64)),
    (64, torch.bfloat16, (64, 64)), (128, torch.bfloat16, (64, 64)),
    (128, torch.float32, (64, 32)), (136, torch.float32, (32, 32)),
    (256, torch.bfloat16, (32, 32))])
def test_flash_tile_rows_from_library(cuda, D, dtype, rows):
    """The tile rows the bench rows report come from the built library:
    the rows a dq block and a dkv block own (32 where two warps share 16
    rows: above D = 128, and in float32's dkv above 64)."""
    assert kf.tile_rows(D, dtype) == rows


def test_flash_kernels_reject_bad_inputs(cuda):
    q = torch.zeros(1, 2, 16, 64, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        kf.flash_forward(*[torch.zeros(1, 2, 16, 12, device=cuda)] * 3,
                         context="cuda")
    with pytest.raises(TypeError):
        kf.flash_forward(q.half(), q.half(), q.half(), context="cuda")
    t = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        kf.flash_forward(q, t, q, context="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kf.flash_forward(q.cpu(), q.cpu(), q.cpu(), context="cuda")
    out, lse = kf.flash_forward(q, q, q, context="cuda")
    with pytest.raises(ValueError, match="lse"):
        kf.dq_cuda(q, q, q, q, lse.double(), lse)
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)                       # contiguous, 4 bytes off
    before = (kf.flash_forward.launches, kf.flash_backward.launches)
    for args in ((shifted, q, q), (q, q, shifted)):
        with pytest.raises(ValueError, match="aligned"):
            kf.flash_forward(*args, context="cuda")
    for args in ((shifted, q, q, q), (q, shifted, q, q), (q, q, q, shifted)):
        for call in (kf.dq_cuda, kf.dkv_cuda):
            with pytest.raises(ValueError, match="aligned"):
                call(*args, lse, lse)
    assert (kf.flash_forward.launches, kf.flash_backward.launches) == before
