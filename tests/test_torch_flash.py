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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash as kf
from repro_torch.kernels import ref as tref

SHAPES = [(2, 3, 64, 16), (1, 2, 128, 8), (2, 3, 77, 16)]
MASKS = [(True, 0), (True, 24), (False, 0), (False, 24)]
FWD_TOL = {"float32": 1e-5, "bfloat16": 4e-2}


def _inputs(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _jax_oracle(arrays, causal, window, dtype=jnp.float32):
    q, k, v = (jnp.asarray(a, dtype) for a in arrays)
    return np.asarray(jref.flash_attention_ref(q, k, v, causal=causal,
                                               window=window), np.float32)


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
    want = jax.grad(lambda q, k, v: jnp.vdot(
        jnp.asarray(c), jref.flash_attention_ref(q, k, v, causal=causal,
                                                 window=window)),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
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
            kf.flash_attention(q, q, q, backend="cuda")


def test_visible_mask_and_tile_rows(monkeypatch):
    m = kf.visible_mask(6, causal=False, window=2)
    assert m.tolist()[3] == [False, False, True, True, True, True]
    assert kf.visible_mask(4, True, 0).sum() == 10
    # the tile rows are the built library's (its values are held on the
    # card); here the query and its refusal go through a stand-in library
    asked = []

    class Lib:
        def flash_tile_rows(self, d):
            asked.append(d)
            return 0 if d % 8 else 32

    monkeypatch.setattr(kf, "_lib", Lib)
    assert kf.tile_rows(64) == 32 and asked == [64]
    with pytest.raises(ValueError, match="head dims"):
        kf.tile_rows(12)
