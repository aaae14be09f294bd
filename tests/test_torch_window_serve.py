"""Whole-prompt admission, sliding-window rings beside the pages and the
dense pool in the port's serving engine against the JAX reference's
`ServeEngine`, at smoke size in float32 on the CPU.

* `gemma3-27b-smoke` (window 16) on the paged pool: prompts of 40, 5, 16,
  20 and 30 tokens (past, below, at and past the window), 8 new tokens
  each, on two slots, so that decodes cross the ring's wrap and later
  requests reuse the slot a 40-token request left; greedy tokens equal
  greedy decoding by the reference's full forward (its engine's rolls a
  ring of 20 or 30 prompt tokens the wrong way: `test_torch_window_lm`).
  The same requests on the dense pool give the same tokens.
* `smollm-135m-smoke` on `pool="dense"` (power-of-two buckets) and on the
  paged pool with `prefill_chunk=0` (whole-bucket admission into pages):
  greedy tokens equal the reference's dense engine's.
* The counterparts of the reference's
  `test_bucketed_prefill_compiles_once_per_bucket` (the port runs the
  whole-prompt prefill eagerly: each prefill's span names its bucket;
  one decode graph, ever) and `test_exact_buckets_for_sequential_state_
  archs` (gemma3, smollm and recurrentgemma buckets equal the reference
  engine's).
* A prefill spliced into a paged slot by `write_slot` equals the
  reference's `write_slot`, pages and rings (its ring's roll undone); `scrub_freed_slots` zeroes
  rings and dense rows; `admission="incremental"` and `spec_k > 0` are
  refused without the chunked paged pool, as the reference refuses them.

The reference engine compiles one prefill per exact length, so each arch
takes at most four prompt lengths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import cache as jcache
from repro.serve import engine as jengine
from repro_torch.configs import registry as treg
from repro_torch.models import lm as tlm
from repro_torch.obs import Tracer
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import cache as tcache
from repro_torch.serve import engine as tengine
from repro_torch.serve import steps as tsteps
from test_torch_window_lm import (carried, fixed_reference_ring,
                                  forward_logits_at)
from test_torch_zoo_lm import _close

GEMMA3 = "gemma3-27b-smoke"
SMOLLM = "smollm-135m-smoke"
RECURRENT = "recurrentgemma-2b-smoke"
NEW = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under the
    suite's parallel workers the threads only contend: this module runs on
    one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def archs():
    return {a: carried(a) for a in (GEMMA3, SMOLLM)}


def _prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _serve(engine, request_cls, prompts, new=NEW):
    futs = [engine.submit(request_cls(prompt=p, max_new_tokens=new))
            for p in prompts]
    engine.run_until_idle(max_ticks=400)
    return [f.result(timeout=0).tokens for f in futs]


def greedy_by_full_forward(jcfg, params, prompt, new, length):
    """``new`` greedy tokens after ``prompt``, each the argmax of the
    reference's full forward at the last position: no cache, no ring."""
    seq = np.asarray(prompt, np.int32)[None]
    for _ in range(new):
        nxt = np.argmax(np.asarray(forward_logits_at(
            jcfg, params, seq, seq.shape[1] - 1, length)), -1)
        seq = np.concatenate([seq, nxt[:, None].astype(np.int32)], 1)
    return seq[0, len(prompt):].tolist()


def test_gemma3_paged_tokens_equal_reference(archs):
    """Rings beside the pages, exact-length admission, slot reuse after a
    longer request; the dense pool gives the same tokens."""
    jcfg, params, tcfg, model = archs[GEMMA3]
    kw = dict(slots=2, max_len=64, page_size=8)
    prompts = _prompts(jcfg.vocab_size, (40, 5, 16, 20, 30))
    want = [greedy_by_full_forward(jcfg, params, p, NEW, 64)
            for p in prompts]
    tracer = Tracer()
    eng = ServeEngine(tcfg, model, seed=0, device="cpu", tracer=tracer,
                      **kw)
    assert eng.pool.kind == "paged" and eng.prefill_chunk is None
    assert set(eng.caches) == {"k", "v", "ring_k", "ring_v"}
    assert eng.caches["ring_k"].shape == (7, 2, 16, 2, 16)
    assert _serve(eng, Request, prompts) == want
    admits = [e["args"]["slot"] for e in tracer.events()
              if e["name"] == "admit"]
    assert admits[:2] == [0, 1] and len(admits) == 5
    assert set(admits[2:]) == {0, 1}
    assert eng.pool.pages_in_use == 0
    dense = ServeEngine(tcfg, model, seed=0, device="cpu", pool="dense",
                        **kw)
    assert dense.caches["k"].shape == (1, 2, 64, 2, 16)
    assert _serve(dense, Request, prompts) == want


def test_smollm_dense_pool_tokens_equal_reference(archs):
    """Power-of-two buckets (8 and 32) on the dense pool; the same
    requests through whole-bucket admission into pages."""
    jcfg, params, tcfg, model = archs[SMOLLM]
    kw = dict(slots=2, max_len=64)
    prompts = _prompts(jcfg.vocab_size, (5, 12, 20, 3))
    want = _serve(JServeEngine(jcfg, params, seed=0, pool="dense", **kw),
                  JRequest, prompts)
    eng = ServeEngine(tcfg, model, seed=0, device="cpu", pool="dense", **kw)
    assert eng.pool.kind == "dense" and eng.prefill_chunk is None
    assert _serve(eng, Request, prompts) == want
    snap = eng.metrics.snapshot()
    assert snap["pool"]["kind"] == "dense" and snap["chunk_ticks"] == 0
    assert snap["prefills"] == 4 and snap["prefill_tokens"] == 40
    whole = ServeEngine(tcfg, model, seed=0, device="cpu", prefill_chunk=0,
                        **kw)
    assert whole.pool.kind == "paged" and whole.prefill_chunk is None
    assert _serve(whole, Request, prompts) == want


def test_bucketed_prefill_runs_once_per_bucket(archs):
    """The reference's test on the dense pool: five prompts in the
    8-bucket, then a 20-token prompt opens the 32-bucket; each prefill
    reports its bucket, and the decode tick builds one graph, ever."""
    _, _, cfg, model = archs[SMOLLM]
    tracer = Tracer()
    eng = ServeEngine(cfg, model, slots=2, max_len=64, seed=0, pool="dense",
                      device="cpu", tracer=tracer)
    prompts = _prompts(cfg.vocab_size, (5, 7, 8, 3, 6, 20), seed=2)
    _serve(eng, Request, prompts[:5], new=2)
    _serve(eng, Request, prompts[5:], new=2)
    spans = [e["args"] for e in tracer.events() if e["name"] == "prefill"]
    assert [a["bucket"] for a in spans] == [8] * 5 + [32]
    assert [a["tokens"] for a in spans] == [5, 7, 8, 3, 6, 20]
    assert not any(a["recompute"] for a in spans)
    key = ("decode", cfg.name, 2, "dense", eng.sampling)
    assert eng.compile_stats["traces"] == {key: 1}
    assert eng.compile_stats["compiles"] == 1


def test_exact_buckets_for_sequential_state_archs(archs):
    """gemma3's rings prefill at exact lengths and never chunk; smollm
    pads to power-of-two buckets; recurrentgemma's state takes the dense
    pool at exact lengths; all as the reference's engines (the engine's
    own list of sequential-state blocks adds `local` to the cache's). An
    arch with a frontend admits whole prompts in power-of-two buckets, as
    the reference's does."""
    for arch, kind in ((GEMMA3, "exact"), (SMOLLM, "pow2"),
                       (RECURRENT, "exact")):
        jcfg, params, tcfg, model = (archs[arch] if arch in archs
                                     else carried(arch))
        j = JServeEngine(jcfg, params, slots=1, max_len=64)
        t = ServeEngine(tcfg, model, slots=1, max_len=64, device="cpu")
        assert t.pool.kind == j.pool.kind == (
            "dense" if arch == RECURRENT else "paged")
        assert t.prefill_chunk == j.prefill_chunk
        lens = range(1, 65)
        assert [t.bucket_for(n) for n in lens] == \
            [j.bucket_for(n) for n in lens]
        assert (t.bucket_for(13) == 13) == (kind == "exact")
    assert "local" not in tcache.SEQUENTIAL_STATE_BLOCKS
    assert tcache.SEQUENTIAL_STATE_BLOCKS == jcache.SEQUENTIAL_STATE_BLOCKS
    assert tengine.SEQUENTIAL_STATE_BLOCKS == jengine.SEQUENTIAL_STATE_BLOCKS
    assert "local" in tengine.SEQUENTIAL_STATE_BLOCKS
    vision = treg.get("internvl2-1b-smoke")
    t = ServeEngine(vision, tlm.LM(vision), slots=1, max_len=64,
                    device="cpu")
    assert t.pool.kind == "paged" and t.prefill_chunk is None
    assert [t.bucket_for(n) for n in (1, 8, 9, 33, 64)] == [8, 8, 16, 64,
                                                            64]


def test_write_slot_equals_reference(archs):
    """A 20-token exact prefill spliced into slot 1 of a paged pool through
    its page row (pages 2, 3 and 4, then the trash page): the pages and
    the rings equal the reference's `write_slot` of its own prefill; the
    slot's reset zeroes its rings and its pages."""
    jcfg, params, tcfg, model = archs[GEMMA3]
    toks = _prompts(jcfg.vocab_size, (20,))[0][None]
    L = 40
    jpool = jcache.PagedCachePool(jcfg, 2, L, page_size=8)
    tpool = tcache.PagedCachePool(tcfg, 2, L, page_size=8, device="cpu")
    for pool in (jpool, tpool):
        pool.alloc_pages(0, 8)
        pool.alloc_pages(1, 24)
    assert tpool.slot_pages(1) == jpool.slot_pages(1) == (2, 3, 4)
    _, sub = jax.jit(jlm.prefill_at, static_argnums=0)(
        jcfg, params, {"tokens": jnp.asarray(toks)},
        jcache.init_caches(jcfg, 1, L), jnp.asarray([19], jnp.int32))
    want = jax.jit(jpool.write_slot)(jpool.init(), sub, jnp.asarray(1),
                                     jpool.page_row(1))
    caches = tpool.init()
    step = tsteps.make_bucket_prefill_step(model, L)
    _, tsub = step(torch.from_numpy(toks), torch.tensor([19]))
    tpool.write_slot(caches, tsub, 1)
    _close(caches["k"][0], want["unit"][5]["self"]["k"][0])
    _close(caches["v"][0], want["unit"][5]["self"]["v"][0])
    for i in range(5):
        _close(caches["ring_k"][i],
               fixed_reference_ring(want["unit"][i]["self"]["k"][0], 20))
    _close(caches["ring_v"][5],
           fixed_reference_ring(want["tail"][0]["self"]["v"], 20))
    tpool.reset_slot(caches, 1)
    assert not caches["ring_k"][:, 1].any()
    assert not caches["k"][:, [2, 3, 4, 0]].any()


@pytest.mark.parametrize("pool", ["paged", "dense"])
def test_scrub_zeroes_rings_and_rows(archs, pool):
    """`scrub_freed_slots` leaves nothing of a finished request: pages,
    rings and dense rows all zero once the engine drains."""
    _, _, cfg, model = archs[GEMMA3]
    eng = ServeEngine(cfg, model, slots=2, max_len=48, page_size=8,
                      pool=pool, scrub_freed_slots=True, device="cpu")
    _serve(eng, Request, _prompts(cfg.vocab_size, (20, 5)), new=4)
    for name, t in eng.caches.items():
        assert not t.any(), name
    keep = ServeEngine(cfg, model, slots=2, max_len=48, page_size=8,
                       pool=pool, device="cpu")
    _serve(keep, Request, _prompts(cfg.vocab_size, (20, 5)), new=4)
    assert all(t.any() for t in keep.caches.values())


@pytest.mark.parametrize("arch,kw", [
    (GEMMA3, {}), (SMOLLM, {"pool": "dense"}),
    (SMOLLM, {"prefill_chunk": 0})],
    ids=["rings", "dense_pool", "no_chunk"])
def test_incremental_and_spec_refused_without_chunking(archs, arch, kw):
    jcfg, params, tcfg, model = archs[arch]
    for extra, what in ((dict(admission="incremental"), "incremental"),
                        (dict(spec_k=3), "spec_k")):
        with pytest.raises(ValueError, match=what):
            JServeEngine(jcfg, params, slots=2, max_len=48,
                         **{**kw, **extra})
        with pytest.raises(ValueError, match=what):
            ServeEngine(tcfg, model, slots=2, max_len=48, device="cpu",
                        **{**kw, **extra})
