"""The port's flash attention (``repro_torch.kernels.flash`` and
``kernels.ref.flash_attention_ref``) against the JAX reference's oracle
``repro.kernels.ref.flash_attention_ref`` and its ``jax.grad``, on the CPU,
where ``flash_attention`` runs the kernels' plain twins.

The reference's Pallas flash kernel is not called: on the installed jax
every call of it raises (``jax.experimental.pallas`` has no ``load``), so
the reference's own flash kernel tests fail here. The port is held against
the oracle, which is how those tests hold the kernel
(``tests/test_kernels.py``, ``tests/test_kernels_grad.py``). Sizes are the
reference tests': B 2, H 3, S 64, D 16; the block-shape case B 1, H 2,
S 128, D 8; and a ragged S 77. Tolerances: forward 1e-5 in float32 and
4e-2 in bfloat16 (``tests/test_kernels.py:125``), gradients rtol = atol =
1e-5 in float32 (``tests/test_kernels_grad.py:28``). Inputs are numpy
normals from a seed, handed to both.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash as kf
from repro_torch.kernels import ref as tref
from test_torch_gpu_kernels import cancel_floor
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

SHAPES = [(2, 3, 64, 16), (1, 2, 128, 8), (2, 3, 77, 16)]
MASKS = [(True, 0), (True, 24), (False, 0), (False, 24)]
FWD_TOL = {"float32": 1e-5, "bfloat16": 4e-2}


def _inputs(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _oracle(causal, window):
    """The reference's oracle under ``jax.jit``, once a mask (eager jax
    costs seconds a call)."""
    return jax.jit(functools.partial(jref.flash_attention_ref, causal=causal,
                                     window=window))


@functools.lru_cache(maxsize=None)
def _oracle_vjp(causal, window):
    """``(q, k, v, c) -> vjp of the oracle at c``, jitted once a mask."""
    def vjp(q, k, v, c):
        return jax.vjp(_oracle(causal, window), q, k, v)[1](c)
    return jax.jit(vjp)


def _jax_oracle(arrays, causal, window, dtype=jnp.float32):
    q, k, v = (jnp.asarray(a, dtype) for a in arrays)
    return np.asarray(_oracle(causal, window)(q, k, v), np.float32)


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_ref_matches_reference_oracle(shape, causal, window, dtype):
    """The port's oracle against the reference's, both in ``dtype``."""
    arrays = _inputs(shape, 3, seed=20)
    want = _jax_oracle(arrays, causal, window, getattr(jnp, dtype))
    got = tref.flash_attention_ref(*_torch(arrays, getattr(torch, dtype)),
                                   causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=FWD_TOL[dtype], atol=FWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_attention_matches_reference_oracle(shape, causal, window,
                                                  dtype):
    """``flash_attention`` on the CPU (the plain twins) in ``dtype`` against
    the reference oracle on the float32 inputs, as the reference's kernel
    test holds its kernel."""
    arrays = _inputs(shape, 3, seed=21)
    want = _jax_oracle(arrays, causal, window)
    q, k, v = _torch(arrays, getattr(torch, dtype))
    got = kf.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=FWD_TOL[dtype], atol=FWD_TOL[dtype])


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_lse_is_logsumexp_of_reference_masked_logits(shape, causal, window):
    arrays = _inputs(shape, 3, seed=22)
    B, H, S, D = shape
    q, k = (jnp.asarray(a) for a in arrays[:2])
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k) * D ** -0.5
    qpos, kpos = jnp.arange(S)[:, None], jnp.arange(S)[None, :]
    mask = jnp.ones((S, S), bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    want = jax.nn.logsumexp(jnp.where(mask, logits, -1e30), axis=-1)
    _, lse = kf.flash_forward(*_torch(arrays), causal=causal, window=window)
    assert lse.dtype == torch.float32 and lse.shape == (B * H, S)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want).reshape(B * H, S),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_grad_matches_reference_jax_grad(shape, causal, window):
    """``torch.autograd.grad`` of ``vdot(c, flash_attention(q, k, v))``
    through ``FlashFn`` (the plain backward twin) against ``jax.grad`` of the
    reference oracle."""
    q, k, v, c = _inputs(shape, 4, seed=40)
    want = _oracle_vjp(causal, window)(
        *(jnp.asarray(a) for a in (q, k, v, c)))
    leaves = [t.requires_grad_() for t in _torch((q, k, v))]
    out = kf.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad((torch.from_numpy(c) * out).sum(), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("causal,window", MASKS)
def test_twins_hold_the_kernels_precision_points(causal, window):
    """bfloat16 in: everything in float32 and one rounding at the end, so
    the bf16 twins equal the float32 twins on the same (exactly upcast)
    values, rounded once; ``lse`` stays float32. The backward twin is the
    exact gradient of the float32 forward (autograd through it)."""
    shape = (2, 3, 77, 16)
    q, k, v, do = _torch(_inputs(shape, 4, seed=50), torch.bfloat16)
    f32 = [t.float() for t in (q, k, v, do)]
    kw = dict(causal=causal, window=window)
    out, lse = kf.flash_fwd_plain(q, k, v, **kw)
    out32, lse32 = kf.flash_fwd_plain(*f32[:3], **kw)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(out, out32.to(torch.bfloat16))
    assert torch.equal(lse, lse32)
    grads = kf.flash_bwd_plain(q, k, v, out, lse, do, **kw)
    grads32 = kf.flash_bwd_plain(*f32[:3], out.float(), lse, f32[3], **kw)
    for g, g32 in zip(grads, grads32):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, g32.to(torch.bfloat16))
    leaves = [t.clone().requires_grad_() for t in f32[:3]]
    o, _ = kf.flash_fwd_plain(*leaves, **kw)
    want = torch.autograd.grad(o, leaves, grad_outputs=f32[3])
    got = kf.flash_bwd_plain(*f32[:3], o.detach(), lse32, f32[3], **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_dq_and_dkv_twins_make_the_backward():
    """The per-kernel twins, fed the wrapper's Δ, give the backward."""
    shape = (1, 2, 40, 8)
    q, k, v, do = _torch(_inputs(shape, 4, seed=51))
    out, lse = kf.flash_fwd_plain(q, k, v)
    delta = kf.row_delta(out, do)
    assert delta.shape == (2, 40)
    dq = kf.flash_dq_plain(q, k, v, do, lse, delta)
    dk, dv = kf.flash_dkv_plain(q, k, v, do, lse, delta)
    for a, b in zip((dq, dk, dv), kf.flash_bwd_plain(q, k, v, out, lse, do)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["head_dim", "dtype", "layout", "shapes",
                                  "cpu_tensor"])
def test_kernel_route_rejects_what_the_kernels_do_not_take(case):
    """The CUDA route's checks, which run before anything is built or
    launched, on CPU tensors."""
    q = torch.zeros(1, 2, 16, 64)
    if case == "head_dim":
        with pytest.raises(ValueError, match="head dims"):
            kf._check(torch.zeros(1, 2, 16, 12))
    elif case == "dtype":
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            kf._check(q.half())
    elif case == "layout":
        with pytest.raises(ValueError, match="contiguous"):
            kf._check(q, q.transpose(2, 3).contiguous().transpose(2, 3))
    elif case == "shapes":
        with pytest.raises(ValueError, match="share shape"):
            kf._check(q, torch.zeros(1, 2, 8, 64))
    else:
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            kf.flash_attention(q, q, q, context="cuda")


def test_visible_mask_and_tile_rows(monkeypatch):
    m = kf.visible_mask(6, causal=False, window=2)
    assert m.tolist()[3] == [False, False, True, True, True, True]
    assert kf.visible_mask(4, True, 0).sum() == 10
    # the tile rows are the built library's (its values are held on the
    # card); here the query and its refusal go through a stand-in library
    asked = []

    class Lib:
        def flash_tile_rows(self, d, dtype, dkv):
            asked.append((d, dtype, dkv))
            return 0 if d % 8 else 32 * (1 + dkv)

    monkeypatch.setattr(kf, "_lib", Lib)
    assert kf.tile_rows(64) == (32, 64)
    assert asked == [(64, 0, 0), (64, 0, 1)]
    assert kf.tile_rows(64, torch.bfloat16) == (32, 64)
    assert asked[2:] == [(64, 1, 0), (64, 1, 1)]
    with pytest.raises(ValueError, match="head dims"):
        kf.tile_rows(12)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kf.tile_rows(64, torch.float16)


# -- the forward kernel's precision points, emulated on the CPU -------------
#
# The kernel (csrc/flash.cu) scales the scores after the product, by
# D^-0.5·log2(e), runs the online softmax in base 2 over key tiles of 64,
# and takes its products on tensor cores: in bfloat16 with p as a hi/lo
# bfloat16 pair, in float32 in 3xTF32; q·kᵀ a fresh sum per 64 dims, each
# tile's p·v a fresh sum added by float32 adds. The emulation repeats those
# arithmetic choices in PyTorch; it must hold the kernel's tolerances
# (chip_smoke.py): o within 1e-5 (float32) / 2e-2 (bfloat16) of max|want|,
# in bfloat16 every row within 1e-2 of its own norm, lse within 1e-5 of
# max|want|.
KERNEL_FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
KERNEL_LSE_TOL = 1e-5
KERNEL_ROW_TOL = 1e-2
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    """The kernels' 3xTF32 split (``flash_common.cuh`` ``split_tf32``):
    big = tf32(x), small = x − big truncated to 10 mantissa bits."""
    big = _tf32(x)
    rest = (x - big).contiguous().view(torch.int32)
    return big, (rest & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as 3xTF32 on the split operands: the two small products, then
    big · big."""
    ab, a_s = _split(a)
    bb, b_s = _split(b)
    return a_s @ bb + ab @ b_s + ab @ bb


def _scores_by_chunks(mm, a, b):
    """a·bᵀ over the last dim, one product per 64 dims, the chunks added
    by float32 adds."""
    out = None
    for d0 in range(0, a.shape[-1], 64):
        part = mm(a[..., d0:d0 + 64], b[..., d0:d0 + 64].transpose(-1, -2))
        out = part if out is None else out + part
    return out


def _tile_product(p, b):
    """p·b for one swept tile: p as a hi/lo bfloat16 pair where b is
    bfloat16-exact (the bfloat16 route), else in 3xTF32."""
    if b.dtype == torch.bfloat16:
        b = b.float()
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        return lo @ b + hi @ b
    return _mm_3xtf32(p, b)


def _emulated_fwd(q, k, v, causal, window, tile=64):
    """(o, lse) with the kernel's precision points, over key tiles: q·kᵀ
    a fresh sum per 64 dims, each tile's p·v a fresh sum added after the
    rescale (the tile products the forward shares with the backward)."""
    B, H, S, D = q.shape
    bf16 = q.dtype == torch.bfloat16
    mm = torch.matmul if bf16 else _mm_3xtf32
    qf = q.float()
    sl2 = (torch.tensor(kf._scale(D), dtype=torch.float32)
           * torch.tensor(LOG2E, dtype=torch.float32))
    mask = kf.visible_mask(S, causal, window)
    m = torch.full((B, H, S, 1), kf.NEG_INF)
    l = torch.zeros(B, H, S, 1)
    acc = torch.zeros(B, H, S, D)
    for k0 in range(0, S, tile):
        kt, vt = k[:, :, k0:k0 + tile], v[:, :, k0:k0 + tile]
        vis = mask[:, k0:k0 + tile]
        s = (_scores_by_chunks(mm, qf, kt.float()) * sl2).masked_fill(
            ~vis, kf.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new).masked_fill(~vis, 0.0)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + _tile_product(p, vt)
        m = m_new
    lm = l.clamp_min(1e-30)
    lse = ((m + torch.log2(lm)) * LN2).reshape(B * H, S)
    return (acc / lm).to(q.dtype), lse


def _close_to_max(got, want, frac, what):
    got, want = got.float(), want.float()
    atol = frac * max(float(want.abs().max()), 1e-3)
    torch.testing.assert_close(got, want, atol=atol, rtol=frac,
                               msg=lambda m: f"{what}: {m}")


def _rows_within(got, want, what):
    err = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1)
    scale = ref + 1e-3 * max(float(ref.max()), 1e-3)
    worst = float((err / scale).max())
    assert worst <= KERNEL_ROW_TOL, f"{what}: a row off by {worst:.3e}"


def test_tf32_rounding_keeps_ten_bits_ties_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -12, 3.0e-3])
    got = _tf32(x)
    assert got[:5].tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                                -(1.0 + 2 ** -10), 1.0]
    assert abs(float(got[5]) - 3.0e-3) <= 3.0e-3 * 2 ** -11
    # small is truncated: -(2^-12 + 2^-23) keeps 2^-12 (rounding, ties
    # away, would give 2^-12 + 2^-22)
    x = torch.tensor([1.0 + 2 ** -11 + 2 ** -13, -(1.0 + 2 ** -12 + 2 ** -23),
                      float("nan"), float("inf")])
    big, small = _split(x)
    assert big[:2].tolist() == [1.0 + 2 ** -10, -1.0]
    assert small[:2].tolist() == [-(2 ** -11 - 2 ** -13), -(2 ** -12)]
    assert torch.isnan(small[2:]).all()      # a NaN or inf makes small NaN
    a = torch.randn(16, 64, generator=torch.Generator().manual_seed(0))
    err = (_mm_3xtf32(a, a.T) - a.double() @ a.double().T).abs().max()
    assert float(err) < 1e-5 * float((a @ a.T).abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_precision_points_hold_the_tolerances(shape, causal, window,
                                                     dtype):
    """The emulated kernel against ``flash_fwd_plain`` and the reference's
    oracle (in float32, on the same values) within the kernel's
    tolerances, on tiles of 64 keys and, for several tiles a row, of 16."""
    q, k, v = _torch(_inputs(shape, 3, seed=23), getattr(torch, dtype))
    want, want_lse = kf.flash_fwd_plain(q, k, v, causal, window)
    oracle = _jax_oracle([t.float().numpy() for t in (q, k, v)], causal,
                         window)
    for tile in (64, 16):
        got, lse = _emulated_fwd(q, k, v, causal, window, tile)
        assert got.dtype == q.dtype
        for w, name in ((want, "flash_fwd_plain"),
                        (torch.from_numpy(oracle.copy()), "oracle")):
            _close_to_max(got, w, KERNEL_FWD_TOL[dtype], f"o vs {name}")
            if dtype == "bfloat16":
                _rows_within(got, w, f"o vs {name}")
        _close_to_max(lse, want_lse, KERNEL_LSE_TOL, "lse")


# -- the backward kernels' precision points, emulated on the CPU ------------
#
# The dq and dkv kernels (csrc/flash_bwd.cu) sweep tiles of 64 rows,
# compute s and dp with a fresh accumulator per 64 dims, p in base 2 as
# 2^(s·D^-0.5·log2(e) − lse·log2(e)), and take ds·k, pᵀ·dO and dsᵀ·q on
# tensor cores: in bfloat16 with p and ds as hi/lo bfloat16 pairs, in
# float32 in 3xTF32; each swept tile's product is a fresh accumulator
# added by float32 adds, and dq and dk are scaled by D^-0.5 at the end.
# The emulation repeats those choices; it must hold the kernels'
# tolerances (chip_smoke.py): dq, dk, dv within 1e-4 (float32) / 5e-2
# (bfloat16) of max|want|, and in bfloat16 every row within 1e-2 of its
# own norm.
KERNEL_GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _probs2(s, lse_rows, scale):
    """p = 2^(s·scale·log2(e) − lse·log2(e)) in float32."""
    return torch.exp2(s * (_f32(scale) * _f32(LOG2E)) - lse_rows * LOG2E)


def _emulated_dq(q, k, v, do, lse, delta, causal, window, tile=64):
    """dq with the dq kernel's precision points, over swept key tiles."""
    B, H, S, D = q.shape
    bf16 = q.dtype == torch.bfloat16
    mm = torch.matmul if bf16 else _mm_3xtf32
    qf, dof = q.float(), do.float()
    lse_r, dlt = lse.reshape(B, H, S, 1), delta.reshape(B, H, S, 1)
    mask = kf.visible_mask(S, causal, window)
    dq = torch.zeros(B, H, S, D)
    for k0 in range(0, S, tile):
        kt, vt = k[:, :, k0:k0 + tile], v[:, :, k0:k0 + tile]
        s = _scores_by_chunks(mm, qf, kt.float())
        dp = _scores_by_chunks(mm, dof, vt.float())
        p = _probs2(s, lse_r, kf._scale(D)).masked_fill(
            ~mask[:, k0:k0 + tile], 0.0)
        dq = dq + _tile_product(p * (dp - dlt), kt)
    return (dq * kf._scale(D)).to(q.dtype)


def _emulated_dkv(q, k, v, do, lse, delta, causal, window, tile=64):
    """(dk, dv) with the dkv kernel's precision points, over swept query
    tiles: sᵀ = k·qᵀ and dpᵀ = v·dOᵀ, then pᵀ·dO and dsᵀ·q."""
    B, H, S, D = q.shape
    bf16 = q.dtype == torch.bfloat16
    mm = torch.matmul if bf16 else _mm_3xtf32
    kf_, vf = k.float(), v.float()
    lse_c = lse.reshape(B, H, 1, S)
    dlt_c = delta.reshape(B, H, 1, S)
    mask_t = kf.visible_mask(S, causal, window).T   # [key, query]
    dk = torch.zeros(B, H, S, D)
    dv = torch.zeros(B, H, S, D)
    for q0 in range(0, S, tile):
        cols = slice(q0, q0 + tile)
        qt, dot = q[:, :, cols], do[:, :, cols]
        s = _scores_by_chunks(mm, kf_, qt.float())
        dp = _scores_by_chunks(mm, vf, dot.float())
        p = _probs2(s, lse_c[..., cols], kf._scale(D)).masked_fill(
            ~mask_t[:, cols], 0.0)
        ds = p * (dp - dlt_c[..., cols])
        dv = dv + _tile_product(p, dot)
        dk = dk + _tile_product(ds, qt)
    return (dk * kf._scale(D)).to(k.dtype), dv.to(v.dtype)


def _jax_grads(arrays, causal, window):
    """jax.grad of vdot(dO, ref.flash_attention_ref(q, k, v)) in float32."""
    grads = _oracle_vjp(causal, window)(*(jnp.asarray(a) for a in arrays))
    return [torch.from_numpy(np.asarray(g).copy()) for g in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_kernel_precision_points_hold_the_tolerances(
        shape, causal, window, dtype):
    """The emulated dq and dkv kernels against the plain twins and against
    the reference's ``jax.grad`` of its oracle (in float32, on the same
    values), within the kernels' tolerances, on swept tiles of 64 and, for
    several tiles a row, of 16. Against the twins both get the emulated
    forward's lse and Δ from its o, as ``flash_backward`` computes them on
    the card. Against ``jax.grad`` the emulation gets the float32 forward's
    lse and Δ: in bfloat16, Δ from the rounded o alone moves a dq row by
    up to 4e-2 of its norm from the float32 gradient (the twins' rows
    too), which is the forward's rounding, not the backward's."""
    q, k, v, do = _torch(_inputs(shape, 4, seed=24), getattr(torch, dtype))
    out, lse = _emulated_fwd(q, k, v, causal, window)
    delta = kf.row_delta(out, do)
    f32 = [t.float() for t in (q, k, v, do)]
    out32, lse32 = kf.flash_fwd_plain(*f32[:3], causal, window)
    delta32 = kf.row_delta(out32, f32[3])
    twins = (kf.flash_dq_plain(q, k, v, do, lse, delta, causal, window),
             *kf.flash_dkv_plain(q, k, v, do, lse, delta, causal, window))
    oracle = _jax_grads([t.numpy() for t in f32], causal, window)

    def emulated(lse, delta, tile):
        return (_emulated_dq(q, k, v, do, lse, delta, causal, window, tile),
                *_emulated_dkv(q, k, v, do, lse, delta, causal, window,
                               tile))

    for tile in (64, 16):
        for against, wants, got in (
                ("twin", twins, emulated(lse, delta, tile)),
                ("jax.grad", oracle, emulated(lse32, delta32, tile))):
            for name, g, w in zip(("dq", "dk", "dv"), got, wants):
                what = f"{name} vs {against}, tile {tile}"
                assert g.dtype == q.dtype and g.shape == q.shape
                _close_to_max(g, w, KERNEL_GRAD_TOL[dtype], what)
                if dtype == "bfloat16":
                    _rows_within(g, w, what)


@pytest.mark.parametrize("D", [8, 64, 256])
def test_one_key_gradients_are_rounding_noise(D):
    """S = 1: each row sees one key, p = 1 and dp = Δ, so the exact dq and
    dk are 0, and the reference's ``jax.grad`` returns exactly 0. The twins
    and the emulated kernels return float32 rounding noise of the terms
    that cancel, within ``cancel_floor`` (the floor the card's tests hold
    the kernels' dq and dk to) of ``jax.grad``; dv within the usual
    tolerance. At the file's other shapes the floor stays below the usual
    tolerance, so it holds nothing else."""
    tol = KERNEL_GRAD_TOL["float32"]
    q, k, v, do = _torch(_inputs((1, 2, 1, D), 4, seed=25))
    oracle = _jax_grads([t.numpy() for t in (q, k, v, do)], True, 0)
    assert float(oracle[0].abs().max()) == float(oracle[1].abs().max()) == 0
    out, lse = kf.flash_fwd_plain(q, k, v)
    delta = kf.row_delta(out, do)
    routes = {"twin": (kf.flash_dq_plain(q, k, v, do, lse, delta),
                       *kf.flash_dkv_plain(q, k, v, do, lse, delta)),
              "emulated": (_emulated_dq(q, k, v, do, lse, delta, True, 0),
                           *_emulated_dkv(q, k, v, do, lse, delta, True,
                                          0))}
    floors = cancel_floor(q, k, v, do, lse, delta)
    for route, grads in routes.items():
        for name, g, w, floor in zip(("dq", "dk", "dv"), grads, oracle,
                                     floors):
            atol = max(tol * max(float(w.abs().max()), 1e-3), floor)
            torch.testing.assert_close(g, w, atol=atol, rtol=tol,
                                       msg=lambda m: f"{name}, {route}: {m}")
    for shape in SHAPES:
        q, k, v, do = _torch(_inputs(shape, 4, seed=24))
        out, lse = kf.flash_fwd_plain(q, k, v)
        delta = kf.row_delta(out, do)
        wants = (kf.flash_dq_plain(q, k, v, do, lse, delta),
                 *kf.flash_dkv_plain(q, k, v, do, lse, delta))
        for w, floor in zip(wants, cancel_floor(q, k, v, do, lse, delta)):
            assert floor < tol * max(float(w.abs().max()), 1e-3), shape
