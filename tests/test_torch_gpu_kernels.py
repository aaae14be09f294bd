"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``gpu``: these skip without a CUDA device. This file imports no JAX,
so it runs on a machine that has only PyTorch; from the repo root:

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu_kernels.py

Tolerances are the reference's own: the sandwich kernel's float32 2e-4 and
bfloat16 5e-2, the paged kernel's float32 1e-5 and bfloat16 2e-2.
"""

import math

import pytest
import torch

from repro_torch.core import layers as blayers
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
    q, k_pool, v_pool, ids, cur = _paged_case(torch.float32, cuda)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q, k_pool, v_pool, ids.long(), cur,
                                  backend="cuda")
