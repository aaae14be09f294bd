"""The port's paged attention (`repro_torch.kernels.paged_attention`)
against the JAX reference on the cases of `tests/test_paged_attention.py`:
a permuted pool, trash and stale pages, chunk queries, float32 and
bfloat16, and a NaN page past `cur_pos`. The port's plain version is held
against the JAX gather oracle and the Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro_torch.kernels import paged_attention as tpa
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

B, P, PS, KV, G, D = 2, 3, 4, 2, 2, 8
N = 1 + B * P
TOLS = {"float32": 1e-5, "bfloat16": 2e-2}


def _setup(seed=0):
    """Random per-slot K/V scattered into a permuted page pool (numpy)."""
    rng = np.random.default_rng(seed)
    L = P * PS
    k = rng.normal(size=(B, L, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, L, KV, D)).astype(np.float32)
    ids = rng.permutation(np.arange(1, N)).reshape(B, P).astype(np.int32)
    k_pool = np.zeros((N, PS, KV, D), np.float32)
    v_pool = np.zeros((N, PS, KV, D), np.float32)
    for b in range(B):
        for p in range(P):
            k_pool[ids[b, p]] = k[b, p * PS:(p + 1) * PS]
            v_pool[ids[b, p]] = v[b, p * PS:(p + 1) * PS]
    return k, k_pool, v_pool, ids


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(a, jnp.dtype(dtype))


def _close(got, want, dtype="float32"):
    tol = TOLS[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_gather_pages_restores_position_order():
    k, k_pool, _, ids = _setup()
    torch.testing.assert_close(tpa.gather_pages(_t(k_pool), _t(ids).int()),
                               _t(k))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_oracle_matches_reference_on_permuted_pool(dtype):
    _, k_pool, v_pool, ids = _setup()
    q = np.random.default_rng(1).normal(size=(B, 1, KV, G, D))
    for pos in (0, 3, 7, 11):
        q_pos = np.full((B, 1), pos, np.int32)
        want = jpa.paged_attend_ref(_j(q, dtype), _j(k_pool, dtype),
                                    _j(v_pool, dtype), _j(ids, "int32"),
                                    _j(q_pos, "int32"))
        got = tpa.paged_attend_ref(_t(q, dtype), _t(k_pool, dtype),
                                   _t(v_pool, dtype), _t(ids).int(),
                                   _t(q_pos).int())
        _close(got, want, dtype)


def test_trash_and_stale_pages_are_unobservable():
    _, k_pool, v_pool, ids = _setup()
    q = np.random.default_rng(2).normal(size=(B, 1, KV, G, D))
    q_pos = np.asarray([[5], [2]], np.int32)
    want = jpa.paged_attend_ref(_j(q), _j(k_pool), _j(v_pool),
                                _j(ids, "int32"), _j(q_pos, "int32"))
    k_dirty, v_dirty = k_pool.copy(), v_pool.copy()
    k_dirty[tpa.TRASH_PAGE] = 1e4
    v_dirty[tpa.TRASH_PAGE] = -1e4
    for b in range(B):
        pos = int(q_pos[b, 0])
        page, off = (pos + 1) // PS, (pos + 1) % PS
        k_dirty[ids[b, page], off:] = 7e3
        v_dirty[ids[b, page], off:] = -7e3
    got = tpa.paged_attend_ref(_t(q), _t(k_dirty), _t(v_dirty),
                               _t(ids).int(), _t(q_pos).int())
    _close(got, want)
    dec = tpa.paged_decode_attention(_t(q[:, 0]), _t(k_dirty), _t(v_dirty),
                                     _t(ids).int(), _t(q_pos[:, 0]).int())
    _close(dec, want[:, 0])


def test_chunk_queries_match_reference_and_single_queries():
    _, k_pool, v_pool, ids = _setup(seed=3)
    Sq = 4
    q = np.random.default_rng(4).normal(size=(B, Sq, KV, G, D))
    q_pos = (5 + np.tile(np.arange(Sq)[None, :], (B, 1))).astype(np.int32)
    want = jpa.paged_attend_ref(_j(q), _j(k_pool), _j(v_pool),
                                _j(ids, "int32"), _j(q_pos, "int32"))
    chunk = tpa.paged_attend_ref(_t(q), _t(k_pool), _t(v_pool),
                                 _t(ids).int(), _t(q_pos).int())
    _close(chunk, want)
    for s in range(Sq):
        single = tpa.paged_decode_attention(
            _t(q[:, s]), _t(k_pool), _t(v_pool), _t(ids).int(),
            _t(q_pos[:, s]).int())
        _close(single, np.asarray(want)[:, s])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_pallas_interpret(dtype):
    _, k_pool, v_pool, ids = _setup(seed=5)
    q = np.random.default_rng(6).normal(size=(B, KV, G, D))
    for pos in (0, 4, 11):
        cur = np.full((B,), pos, np.int32)
        want = jpa._paged_decode_pallas(
            _j(q, dtype), _j(k_pool, dtype), _j(v_pool, dtype),
            _j(ids, "int32"), _j(cur, "int32"), interpret=True)
        got = tpa.paged_decode_attention(_t(q, dtype), _t(k_pool, dtype),
                                         _t(v_pool, dtype), _t(ids).int(),
                                         _t(cur).int())
        _close(got, want, dtype)


def test_nan_page_past_cur_pos_stays_out():
    """A NaN-filled page wholly past ``cur_pos`` must not reach the
    output: the reference's kernel skips it structurally, the port's plain
    version masks it out of both the scores and V."""
    _, k_pool, v_pool, ids = _setup(seed=7)
    k_dirty, v_dirty = k_pool.copy(), v_pool.copy()
    k_dirty[ids[0, 2]] = np.nan
    v_dirty[ids[0, 2]] = np.nan
    q = np.random.default_rng(8).normal(size=(B, KV, G, D))
    cur = np.asarray([3, 11], np.int32)
    want = jpa._paged_decode_pallas(_j(q), _j(k_dirty), _j(v_dirty),
                                    _j(ids, "int32"), _j(cur, "int32"),
                                    interpret=True)
    got = tpa.paged_decode_attention(_t(q), _t(k_dirty), _t(v_dirty),
                                     _t(ids).int(), _t(cur).int())
    assert torch.isfinite(got).all()
    _close(got, want)


def test_cuda_backend_rejects_cpu_tensors():
    _, k_pool, v_pool, ids = _setup()
    q = _t(np.zeros((B, KV, G, D)))
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode_attention(q, _t(k_pool), _t(v_pool), _t(ids).int(),
                                   torch.zeros(B, dtype=torch.int32),
                                   context="cuda")


# the split's plain twin: 6 slots over 5 pages of 4 positions, cur_pos at
# 0, ps - 1, ps, a run boundary (8 starts the second run of 2 pages, 12 the
# second of 3) and the last position
SPLIT_PAGES, SPLIT_CUR = 5, (0, PS - 1, PS, 8, 12, 5 * PS - 1)


def _split_setup(seed):
    """A permuted pool for SPLIT_CUR with a dirty trash page, stale finite
    rows past cur_pos in each slot's last page and NaN pages wholly past
    it (the reference's kernel skips those, and scores the stale rows only
    to mask them, so they must stay finite)."""
    rng = np.random.default_rng(seed)
    Bs, P = len(SPLIT_CUR), SPLIT_PAGES
    n = 1 + Bs * P
    k_pool = rng.normal(size=(n, PS, KV, D)).astype(np.float32)
    v_pool = rng.normal(size=(n, PS, KV, D)).astype(np.float32)
    ids = rng.permutation(np.arange(1, n)).reshape(Bs, P).astype(np.int32)
    k_pool[tpa.TRASH_PAGE] = 1e4
    v_pool[tpa.TRASH_PAGE] = -1e4
    for b, cur in enumerate(SPLIT_CUR):
        last, off = cur // PS, cur % PS + 1
        k_pool[ids[b, last], off:] = 7e3
        v_pool[ids[b, last], off:] = -7e3
        for p in range(last + 1, P):
            k_pool[ids[b, p]] = np.nan
            v_pool[ids[b, p]] = np.nan
    q = rng.normal(size=(Bs, KV, G, D))
    return q, k_pool, v_pool, ids, np.asarray(SPLIT_CUR, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pages", [1, 2, 3, SPLIT_PAGES])
def test_split_twin_matches_oracle_and_pallas(pages, dtype):
    """``paged_decode_split_plain`` over runs of 1, 2, 3 and all pages
    against the port's oracle and the reference's Pallas kernel in
    interpret mode."""
    q, k_pool, v_pool, ids, cur = _split_setup(seed=9)
    got = tpa.paged_decode_split_plain(
        _t(q, dtype), _t(k_pool, dtype), _t(v_pool, dtype), _t(ids).int(),
        _t(cur).int(), pages)
    assert got.dtype == getattr(torch, dtype)
    assert torch.isfinite(got).all()
    oracle = tpa.paged_attend_ref(
        _t(q[:, None], dtype), _t(k_pool, dtype), _t(v_pool, dtype),
        _t(ids).int(), _t(cur[:, None]).int())[:, 0]
    _close(got, oracle.float().numpy(), dtype)
    pallas = jpa._paged_decode_pallas(
        _j(q, dtype), _j(k_pool, dtype), _j(v_pool, dtype),
        _j(ids, "int32"), _j(cur, "int32"), interpret=True)
    _close(got, pallas, dtype)


def test_split_twin_gives_zeros_before_the_first_position():
    """A slot with cur_pos -1 (nothing written) sees no position: zeros,
    as the oracle gives, whatever the pool holds."""
    q, k_pool, v_pool, ids, cur = _split_setup(seed=10)
    cur = cur.copy()
    cur[1] = -1
    got = tpa.paged_decode_split_plain(_t(q), _t(k_pool), _t(v_pool),
                                       _t(ids).int(), _t(cur).int(), 2)
    assert not got[1].any() and torch.isfinite(got).all()
    want = tpa.paged_attend_ref(_t(q[:, None]), _t(k_pool), _t(v_pool),
                                _t(ids).int(), _t(cur[:, None]).int())[:, 0]
    _close(got, want.numpy())


def test_pages_per_split_covers_64_positions():
    """Runs of 64 positions, at least one page, and at most MAX_RUNS runs a
    slot (the combine keeps a table of them in shared memory)."""
    assert [tpa.pages_per_split(ps, 32) for ps in (1, 4, 16, 64, 128)] == [
        64, 16, 4, 1, 1]
    assert tpa.pages_per_split(16, 2048) == 4
    assert tpa.pages_per_split(16, 4096) == 8
    assert -(-100000 // tpa.pages_per_split(1, 100000)) <= tpa.MAX_RUNS
    assert tpa.PAGED_KERNELS == 2
