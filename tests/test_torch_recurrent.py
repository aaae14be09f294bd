"""The port's recurrent blocks (`repro_torch.models.rglru`,
`repro_torch.models.xlstm`) against the JAX reference's, at smoke size on
the CPU: weights drawn by the port and carried over through numpy, inputs
made from a seed with numpy.

* `_causal_conv` with and without a history, float32 and bfloat16.
* `rglru_scan` (the port's log-depth doubling scan) against the
  reference's `associative_scan` at the reference test's rtol 1e-4 / atol
  1e-5, with and without `h0`, and against a loop of `rglru_step`.
* `mlstm_recurrent`, `mlstm_parallel` and `mlstm_chunkwise` at chunks 4, 8
  and 16 against the reference's, and the chunkwise state handed from one
  half of a sequence to the other against the whole.
* `_slstm_scan` from the serving init state.
* Each block (`rglru_block`, `mlstm_block`, `slstm_block`) in train,
  prefill and decode mode: outputs and the caches it writes in place
  against the reference's returned caches, and in train mode the gradient
  of every parameter against `jax.grad`; float32 at 1e-5 of the largest
  magnitude, bfloat16 at 4e-2. The mLSTM's prefill runs at 12 tokens (the
  parallel form, then `mlstm_recurrent` for the state), 32 (two chunks)
  and 20 (padded with state-neutral steps to two chunks). A prompt of 1 or
  2 tokens leaves the reference a conv history of fewer rows than its cache
  (ROADMAP queue 3): the port's is held there against the last `W - 1`
  rows of the zero-padded input.

The reference's calls run under `jax.jit`, since eager jax costs seconds a
call.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import rglru as jrg
from repro.models import xlstm as jxm
from repro_torch.configs import registry as treg
from repro_torch.models import rglru as trg
from repro_torch.models import xlstm as txm
from repro_torch.serve import cache as tcache

RG, XL = "recurrentgemma-2b-smoke", "xlstm-125m-smoke"
TOL = {"float32": 1e-5, "bfloat16": 4e-2}
B = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under the
    suite's parallel workers the threads only contend: this module runs on
    one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    """Within ``tol`` of the largest magnitude of ``want`` (and relative to
    each element)."""
    got = np.asarray(got.detach().float().numpy() if torch.is_tensor(got)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def _cfgs(arch, dtype="float32"):
    return (jreg.get(arch).with_(compute_dtype=dtype),
            treg.get(arch).with_(compute_dtype=dtype))


def _jparams(module):
    return {k: jnp.asarray(v.detach().numpy())
            for k, v in module.named_parameters()}


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _pair(a, dtype):
    """``a`` (numpy) as a reference array and a port tensor of ``dtype``."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a).to(getattr(torch, dtype)))


@functools.lru_cache(maxsize=None)
def _module(kind, arch):
    cls = {"rec": trg.RGLRU, "mlstm": txm.MLSTM, "slstm": txm.SLSTM}[kind]
    return cls(treg.get(arch).with_(compute_dtype="float32"),
               generator=torch.Generator().manual_seed(1))


# -- the functions ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_history", [False, True])
def test_causal_conv_matches_reference(with_history, dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(_randn(rng, B, 9, 64), dtype)
    jk, tk = _pair(_randn(rng, 4, 64, scale=0.5), "float32")
    jh = th = None
    if with_history:
        jh, th = _pair(_randn(rng, B, 3, 64), dtype)
    want = jax.jit(jrg._causal_conv)(jx, jk, jh)
    _close(trg._causal_conv(tx, tk, th), want, TOL[dtype])


def test_conv_history_left_pads_short_inputs():
    """The rows a next step reads: the last W-1 of ``[zeros; u]`` without a
    history, of ``[history; u]`` with one, in the history's dtype."""
    u = torch.arange(1, 7, dtype=torch.float32).reshape(1, 2, 3)
    h = trg.conv_history(u, 4)
    assert h.shape == (1, 3, 3)
    assert torch.equal(h[0, 0], torch.zeros(3))
    assert torch.equal(h[0, 1:], u[0])
    hist = torch.full((1, 3, 3), 9.0, dtype=torch.bfloat16)
    h2 = trg.conv_history(u[:, :1], 4, hist)
    assert h2.dtype == torch.bfloat16
    assert torch.equal(h2[0, :2].float(), torch.full((2, 3), 9.0))
    assert torch.equal(h2[0, 2].float(), u[0, 0])
    assert trg.conv_history(u, 1).shape == (1, 0, 3)


@pytest.mark.parametrize("S", [1, 7, 64])
def test_rglru_scan_matches_reference_and_step(S):
    """At the reference test's tolerances (rtol 1e-4, atol 1e-5); with
    ``h0`` too; and a loop of `rglru_step` gives the same states."""
    rec = _module("rec", RG)
    p = _jparams(rec)
    rng = np.random.default_rng(S)
    x = _randn(rng, B, S, 64)
    h0 = _randn(rng, B, 64)
    for h in (None, h0):
        want, want_last = jax.jit(jrg.rglru_scan)(
            p, jnp.asarray(x), None if h is None else jnp.asarray(h))
        with torch.no_grad():
            got, got_last = trg.rglru_scan(
                rec, torch.from_numpy(x),
                None if h is None else torch.from_numpy(h))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got_last.numpy(), want_last, rtol=1e-4,
                                   atol=1e-5)
    with torch.no_grad():
        hs, state = [], torch.from_numpy(h0)
        for t in range(S):
            o, state = trg.rglru_step(rec, torch.from_numpy(x[:, t:t + 1]),
                                      state)
            hs.append(o)
        full, _ = trg.rglru_scan(rec, torch.from_numpy(x),
                                 torch.from_numpy(h0))
    np.testing.assert_allclose(torch.cat(hs, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_linear_scan_keeps_underflowing_decays_finite():
    """Decays of exp(-8 softplus(Λ) r) underflow to 0 within tens of steps;
    the doubling scan multiplies and never divides, so states and their
    gradients stay finite."""
    a = torch.full((1, 256, 4), 1e-3, requires_grad=True)
    b = torch.ones((1, 256, 4), requires_grad=True)
    A, H = trg.linear_scan(a, b)
    (A.sum() + H.sum()).backward()
    assert float(A[0, -1, 0].detach()) == 0.0
    assert bool(torch.isfinite(H).all()) and bool(torch.isfinite(a.grad).all())
    np.testing.assert_allclose(H[0, -1].detach().numpy(), 1.001001, rtol=1e-6)


def _mlstm_inputs(S, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (_randn(rng, B, S, 4, 32) for _ in range(3))
    ig = _randn(rng, B, S, 4)
    fg = _randn(rng, B, S, 4) + 2.0
    return q, k, v, ig, fg


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mlstm_forms_match_reference(chunk):
    """The three forms against the reference's at S = 16 (the recurrent
    form's state too), the port's forms against each other, and the
    chunkwise state handed from the first half to the second against the
    whole sequence."""
    S = 16
    xs = _mlstm_inputs(S, chunk)
    want_rec, want_st = jax.jit(jxm.mlstm_recurrent)(*_j(*xs))
    got_rec, got_st = txm.mlstm_recurrent(*_t(*xs))
    _close(got_rec, want_rec, 1e-5)
    for g, w in zip(got_st, want_st):
        _close(g, w, 1e-5)
    want_par = jax.jit(jxm.mlstm_parallel)(*_j(*xs))
    _close(txm.mlstm_parallel(*_t(*xs)), want_par, 1e-5)
    want_ch, want_cst = jax.jit(functools.partial(
        jxm.mlstm_chunkwise, chunk=chunk, return_state=True))(*_j(*xs))
    got_ch, got_cst = txm.mlstm_chunkwise(*_t(*xs), chunk,
                                          return_state=True)
    _close(got_ch, want_ch, 1e-5)
    for g, w in zip(got_cst, want_cst):
        _close(g, w, 1e-5)
    _close(got_ch, got_rec.numpy(), 1e-4)
    first = [a[:, :S // 2] for a in _t(*xs)]
    second = [a[:, S // 2:] for a in _t(*xs)]
    h1, st = txm.mlstm_chunkwise(*first, chunk, return_state=True)
    h2, st2 = txm.mlstm_chunkwise(*second, chunk, state=st,
                                  return_state=True)
    _close(torch.cat([h1, h2], 1), got_ch.numpy(), 1e-5)
    for g, w in zip(st2, got_cst):
        _close(g, w.numpy(), 1e-5)


def test_slstm_scan_matches_reference():
    jcfg, tcfg = _cfgs(XL)
    blk = _module("slstm", XL)
    rng = np.random.default_rng(3)
    pre = _randn(rng, B, 9, 4 * 64)
    jstate = jxm.init_slstm_cache(jcfg, B)
    want, want_st = jax.jit(jxm._slstm_scan, static_argnums=0)(
        jcfg, _jparams(blk), jnp.asarray(pre), jstate)
    with torch.no_grad():
        got, got_st = txm._slstm_scan(tcfg, blk, torch.from_numpy(pre),
                                      txm._init_slstm_state(tcfg, B, "cpu"))
    _close(got, want, 1e-5)
    for t in ("c", "n", "m", "h"):
        _close(got_st[t], want_st[t], 1e-5)


def test_recurrent_matrix_is_the_reference_layout():
    """``h @ _recurrent_matrix(r_zifo)`` is the reference's
    ``_interleave(einsum(h, r_zifo))``: the (H, 4, D) layout taken to
    (4, H, D), so ``r_zifo`` carries across without a permutation; each
    product sums the same terms, the others exact zeros."""
    rng = np.random.default_rng(4)
    h, r = _randn(rng, 3, 64), _randn(rng, 4, 16, 64)
    rec = jnp.einsum("bhd,hdf->bhf", jnp.asarray(h).reshape(3, 4, 16),
                     jnp.asarray(r)).reshape(3, 256)
    want = jxm._interleave(rec, 64, 4, 16)
    got = torch.from_numpy(h) @ txm._recurrent_matrix(torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    index = np.arange(4 * 16 * 64, dtype=np.float32).reshape(4, 16, 64)
    full = txm._recurrent_matrix(torch.from_numpy(index))
    # row 16 is head 1's first input; column g * 64 + h * 16 + d is gate g
    # of head h's output d
    assert float(full[16, 16]) == index[1, 0, 0]
    assert float(full[16, 64 + 16 + 3]) == index[1, 0, 16 + 3]
    assert float(full[16, 3]) == float(full[16, 64 + 32]) == 0.0


# -- the blocks -------------------------------------------------------------

BLOCKS = {"rec": (RG, jrg.rglru_block, trg.rglru_block,
                  jrg.init_rglru_cache),
          "mlstm": (XL, jxm.mlstm_block, txm.mlstm_block,
                    jxm.init_mlstm_cache),
          "slstm": (XL, jxm.slstm_block, txm.slstm_block,
                    jxm.init_slstm_cache)}


def _port_cache(kind, tcfg):
    spec = tcache.layer_cache_spec(tcfg, kind, B, 64)
    return {f: torch.full(shape, fill, dtype=dt)
            for f, (shape, dt, fill) in spec.items()}


def _run_block(kind, dtype, S, mode, cache_np=None, seed=0):
    """(reference out, reference cache, port out, port cache) of one call;
    ``cache_np`` the incoming cache (numpy), the init cache without."""
    arch, jfn, tfn, jinit = BLOCKS[kind]
    jcfg, tcfg = _cfgs(arch, dtype)
    blk = _module(kind, arch)
    rng = np.random.default_rng(seed)
    jx, tx = _pair(_randn(rng, B, S, 64), dtype)
    jcache = jinit(jcfg, B)
    if cache_np is not None:
        jcache = {k: jnp.asarray(cache_np[k]).astype(v.dtype)
                  for k, v in jcache.items()}
    tcache_ = _port_cache(kind, tcfg)
    if cache_np is not None:
        for k, v in cache_np.items():
            tcache_[k].copy_(torch.from_numpy(np.array(v, np.float32)))
    want, want_cache = jax.jit(functools.partial(jfn, mode=mode),
                               static_argnums=0)(jcfg, _jparams(blk), jx,
                                                 cache=jcache)
    with torch.no_grad():
        got = tfn(tcfg, blk, tx, mode=mode,
                  cache=None if mode == "train" else tcache_)
    return want, want_cache, got, tcache_


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,S", [("rec", 13), ("mlstm", 12),
                                    ("mlstm", 20), ("mlstm", 32),
                                    ("slstm", 13)])
def test_block_prefill_then_decode_matches_reference(kind, S, dtype):
    """Train-mode and prefill outputs, the prefilled cache, then three
    decode steps from the reference's cache: outputs and caches each
    step."""
    tol = TOL[dtype]
    want, _, got, _ = _run_block(kind, dtype, S, "train")
    _close(got, want, tol)
    want, jc, got, tc = _run_block(kind, dtype, S, "prefill")
    _close(got, want, tol)
    for f, t in tc.items():
        _close(t, jc[f], tol)
    cache_np = {k: np.asarray(v.astype(jnp.float32)) for k, v in jc.items()}
    for step in range(3):
        want, jc, got, tc = _run_block(kind, dtype, 1, "decode", cache_np,
                                       seed=10 + step)
        _close(got, want, tol)
        for f, t in tc.items():
            _close(t, jc[f], tol)
        cache_np = {k: np.asarray(v.astype(jnp.float32))
                    for k, v in jc.items()}


@pytest.mark.parametrize("kind", ["rec", "mlstm"])
@pytest.mark.parametrize("S", [1, 2])
def test_short_prefill_keeps_a_zero_padded_history(kind, S):
    """A prompt shorter than W-1 = 3: the port's conv history is the
    prompt's rows after W-1-S zero rows (the reference's keeps S rows, the
    fault of ROADMAP queue 3), the rest of the state equals the
    reference's."""
    want, jc, got, tc = _run_block(kind, "float32", S, "prefill")
    _close(got, want, 1e-5)
    assert tuple(jc["conv"].shape[1:]) == (S, tc["conv"].shape[-1])
    assert tc["conv"].shape[1] == 3
    assert not bool(tc["conv"][:, :3 - S].any())
    _close(tc["conv"][:, 3 - S:], jc["conv"], 1e-5)
    for f, t in tc.items():
        if f != "conv":
            _close(t, jc[f], 1e-5)


@pytest.mark.parametrize("kind,S", [("rec", 13), ("mlstm", 20),
                                    ("slstm", 9)])
def test_block_gradients_match_reference(kind, S):
    """Train mode: d(sum(out * g)) for the input and every parameter
    against `jax.grad` of the reference's block, float32."""
    arch, jfn, tfn, _ = BLOCKS[kind]
    jcfg, tcfg = _cfgs(arch)
    blk = _module(kind, arch)
    rng = np.random.default_rng(7)
    x, g = _randn(rng, B, S, 64), _randn(rng, B, S, 64)

    def jloss(params, x):
        out, _ = jfn(jcfg, params, x, mode="train")
        return jnp.sum(out * g)

    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        _jparams(blk), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    blk.zero_grad()
    (tfn(tcfg, blk, tx, mode="train") * torch.from_numpy(g)).sum().backward()
    _close(tx.grad, want_x, 1e-5)
    for name, p in blk.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        _close(p.grad, want_p[name], 1e-5)
    blk.zero_grad()
