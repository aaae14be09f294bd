"""The port's serving engine (`repro_torch.serve`) against the JAX
reference, plus its page pool and its import and device rules.

Greedy outputs of the port's `ServeEngine` must equal the JAX unsharded
`ServeEngine`'s token for token on the same carried weights in float32;
`slots=2` with 4 requests makes slots refill, and one prompt is longer
than the 16-token prefill chunk.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import registry as treg
from repro_torch.kernels.paged_attention import TRASH_PAGE
from repro_torch.serve import (PagedCachePool, PoolExhausted, Request,
                               SamplingParams, ServeEngine, loader,
                               sample_logits)

from test_torch_lm import carried_models

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def models():
    return carried_models(seed=1)


def test_engine_greedy_tokens_match_reference_engine(models):
    jcfg, params, tcfg, model = models
    rng = np.random.default_rng(3)
    lens = (5, 23, 11, 3)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    jeng = JServeEngine(jcfg, params, slots=2, max_len=48, seed=0)
    teng = ServeEngine(tcfg, model, slots=2, max_len=48, device="cpu")
    jf = [jeng.submit(JRequest(prompt=p, max_new_tokens=6)) for p in prompts]
    tf = [teng.submit(Request(prompt=p, max_new_tokens=6)) for p in prompts]
    jeng.run_until_idle()
    teng.run_until_idle()
    for j, t in zip(jf, tf):
        assert t.result().tokens == j.result().tokens
    snap = teng.metrics.snapshot()
    assert snap["requests_finished"] == 4
    assert snap["max_concurrent_slots"] == 2
    assert snap["chunk_ticks"] >= 2          # the 23-token prompt chunks twice
    assert teng.pool.pages_in_use == 0


def test_decode_logits_leave_engine_state_untouched(models):
    _, _, tcfg, model = models
    eng = ServeEngine(tcfg, model, slots=2, max_len=48, device="cpu")
    eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=4))
    eng.step()
    before = {t: c.clone() for t, c in eng.caches.items()}
    a = eng.decode_logits()
    b = eng.decode_logits(backend="torch")
    torch.testing.assert_close(a, b)
    for t in before:
        torch.testing.assert_close(eng.caches[t], before[t])
    with pytest.raises(RuntimeError):
        ServeEngine(tcfg, model, slots=1, max_len=48,
                    device="cpu").decode_logits()


def _pool(slots=2, max_len=32, num_pages=None):
    cfg = treg.get("smollm-135m-smoke")
    return PagedCachePool(cfg, slots, max_len, page_size=8,
                          num_pages=num_pages, device="cpu")


def test_pool_free_list_is_fifo_and_recycles():
    pool = _pool()
    assert pool.free_list() == tuple(range(1, pool.total_pages))
    pool.alloc_pages(0, 10)                    # 2 pages
    pool.alloc_pages(1, 3)                     # 1 page
    assert pool.slot_pages(0) == (1, 2) and pool.slot_pages(1) == (3,)
    pool.free(0)
    assert pool.free_list()[-2:] == (1, 2)     # recycled at the tail
    pool.alloc_pages(1, 17)                    # grows by 2 more pages
    assert pool.slot_pages(1) == (3, 4, 5)
    assert pool.pages_hwm == 3


def test_pool_trash_page_never_allocated_and_table_reset():
    pool = _pool()
    pool.alloc_pages(0, 32)
    pool.alloc_pages(1, 32)
    table = pool.gather_args()["page_table"]
    assert table.dtype == torch.int32
    assert TRASH_PAGE not in table.tolist()[0] + table.tolist()[1]
    pool.free(1)
    assert pool.gather_args()["page_table"][1].tolist() == \
        [TRASH_PAGE] * pool.pages_per_slot
    caches = pool.init()
    assert caches["k"].shape == (2, pool.total_pages, 8, 2, 16)


def test_pool_exhaustion_raises_and_engine_defers(models):
    pool = _pool(num_pages=4)                  # 3 usable pages
    pool.alloc_pages(0, 24)
    with pytest.raises(PoolExhausted):
        pool.alloc_pages(1, 9)
    with pytest.raises(PoolExhausted):
        pool.alloc_pages(1, 33)                # past the table's reach
    _, _, tcfg, model = models
    eng = ServeEngine(tcfg, model, slots=2, max_len=32, num_pages=3,
                      device="cpu")            # 2 usable pages of 16
    a = eng.submit(Request(prompt=[1] * 20, max_new_tokens=4))
    b = eng.submit(Request(prompt=[2] * 20, max_new_tokens=4))
    eng.step()
    assert eng.occupied_slots() == 1 and eng.queued() == 1
    eng.run_until_idle()
    assert len(a.result().tokens) == len(b.result().tokens) == 4
    assert eng.metrics.snapshot()["pool"]["exhausted_events"] >= 1


def test_submit_validation(models):
    _, _, tcfg, model = models
    eng = ServeEngine(tcfg, model, slots=1, max_len=16, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(Request(prompt=[1] * 10, max_new_tokens=8))
    with pytest.raises(TypeError):
        eng.submit([1, 2, 3])
    with pytest.raises(ValueError):
        eng.submit(Request(prompt=[1], sampling=SamplingParams(0.5)))
    with pytest.raises(ValueError):
        Request(prompt=[])


def test_sampling_greedy_and_top_k():
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.0]])
    assert sample_logits(logits, None, SamplingParams()).tolist() == [1]
    gen = torch.Generator().manual_seed(0)
    draws = {int(sample_logits(logits, gen,
                               SamplingParams(temperature=1.0, top_k=2)))
             for _ in range(50)}
    assert draws <= {1, 3} and len(draws) == 2


def test_engine_without_device_and_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = treg.get("smollm-135m-butterfly-smoke")
    model = loader.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, model, slots=1, max_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader.init_params(cfg, seed=0)


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys, repro_torch.serve.engine, repro_torch.convert, "
            "repro_torch.train.trainer, repro_torch.train.steps, "
            "repro_torch.optim.optimizer, repro_torch.data.pipeline, "
            "repro_torch.checkpoint.checkpointing, "
            "repro_torch.runtime.fault_tolerance, repro_torch.core.encdec, "
            "repro_torch.kernels.butterfly, repro_torch.launch.encdec, "
            "repro_torch.data.synthetic, repro_torch.kernels.flash, "
            "repro_torch.launch.speed; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'benchmarks')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
