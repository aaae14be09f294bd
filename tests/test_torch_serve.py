"""The port's serving engine (`repro_torch.serve`) against the JAX
reference, plus its page pool and its import and device rules.

Greedy outputs of the port's `ServeEngine` must equal the JAX unsharded
`ServeEngine`'s token for token on the same carried weights in float32;
`slots=2` with 4 requests makes slots refill, and one prompt is longer
than the 16-token prefill chunk. On the card (marked ``gpu``), the same
prompts through the kernels must give the CPU plain path's tokens, which
closes the chain from the card to the reference; on the card the engine
replays CUDA graphs of its ticks, and the ``gpu`` tests also hold the
decode and verify replays against the same passes run eagerly and the
launch counters against the per-tick formula. The reference is imported
inside the tests that use it, so the card's machine, which has no JAX,
runs the ``gpu`` tests from the repo root with

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_serve.py
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.kernels.paged_attention import TRASH_PAGE
from repro_torch.serve import (PagedCachePool, PoolExhausted, Request,
                               SamplingParams, ServeEngine, loader,
                               sample_logits)
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def models():
    from test_torch_lm import carried_models
    return carried_models(seed=1)


def test_engine_greedy_tokens_match_reference_engine(models):
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine
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
    b = eng.decode_logits(context="torch")
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
            "repro_torch.launch.speed, repro_torch.serve.faults, "
            "repro_torch.serve.graphs, repro_torch.obs, "
            "repro_torch.obs.tracing, repro_torch.obs.registry, "
            "repro_torch.obs.validate, repro_torch.obs.profiling, "
            "repro_torch.serve.client, repro_torch.serve.trace, "
            "repro_torch.serve.router, repro_torch.serve.loader, "
            "repro_torch.launch.serve, repro_torch.launch.bench_serving, "
            "repro_torch.core.sketch, repro_torch.core.layers, "
            "repro_torch.nn, repro_torch.runtime.pytree, "
            "repro_torch.launch.paper, repro_torch.examples, "
            "repro_torch.examples.quickstart, "
            "repro_torch.examples.learned_sketch, "
            "repro_torch.examples.butterfly_autoencoder, "
            "repro_torch.examples.train_lm, repro_torch.examples.serve_lm; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'benchmarks')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


def _smoke_script():
    """``chip_smoke.py`` as a module (its phases are the card checks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run `pytest -m gpu` on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(SRC, "..", "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["eager", "incremental", "spec", "router"])
def test_greedy_tokens_on_card_match_cpu_plain_path(mode):
    """``chip_smoke.py``'s token phase: ``smollm-135m-butterfly-smoke`` in
    float32, weights made once on the CPU, served through the kernels on
    graphs on the card and through the plain versions on the CPU with the
    prompts of the test above (slots 2, chunks of 16, 16 new tokens), under
    eager admission, incremental admission with a preemption, ``spec_k=3``,
    and two replicas behind a ``Router`` on its driver thread with a
    checkpoint swapped into replica 0 mid-run: every token equal, or the
    phase prints the request, step and logit gap and raises."""
    smoke = _smoke_script()
    smoke.serve_tokens_case(torch, np, torch.device("cuda"), mode)


@pytest.mark.gpu
def test_graph_replay_matches_eager_tick_at_full_width():
    """Full-width ``smollm-135m-butterfly`` in bfloat16, 8 slots: a replay of
    the decode graph gives the logits of the same tick run eagerly through
    the kernels (``decode_logits(context="cuda")``) within the bfloat16
    layer tolerance; whether bit for bit is printed."""
    smoke = _smoke_script()
    from repro_torch.configs import registry
    cfg = registry.get("smollm-135m-butterfly")
    dev = torch.device("cuda")
    eng = ServeEngine(cfg, loader.init_params(cfg, seed=0, device=dev),
                      slots=8, max_len=512, device=dev)
    rng = np.random.default_rng(4)
    for n in range(8):
        eng.submit(Request(prompt=rng.integers(0, cfg.vocab_size, 5 + n),
                           max_new_tokens=8))
    eng.step()
    eng.step()
    out = smoke.replay_vs_eager(torch, eng, "cuda")
    assert out["rel"] <= smoke.LAYER_TOL
    print(f"replay vs eager: bit for bit {out['bitwise']}, relative norm "
          f"{out['rel']:.3e}")


@pytest.mark.gpu
def test_verify_replay_matches_eager_pass_at_full_width():
    """Full-width ``smollm-135m-butterfly`` in bfloat16, 8 slots, ``spec_k``
    3: replays of the draft and verify graphs give the verify logits of the
    same pass run eagerly through the kernels on the same drafts within the
    bfloat16 layer tolerance; whether bit for bit is printed."""
    smoke = _smoke_script()
    from repro_torch.configs import registry
    cfg = registry.get("smollm-135m-butterfly")
    dev = torch.device("cuda")
    eng = ServeEngine(cfg, loader.init_params(cfg, seed=0, device=dev),
                      slots=8, max_len=512, spec_k=3, device=dev)
    rng = np.random.default_rng(4)
    for n in range(8):
        eng.submit(Request(prompt=rng.integers(0, cfg.vocab_size, 5 + n),
                           max_new_tokens=16))
    eng.step()
    out = smoke.verify_replay_vs_eager(torch, eng, "cuda")
    assert out["rel"] <= smoke.LAYER_TOL
    print(f"verify replay vs eager: bit for bit {out['bitwise']}, relative "
          f"norm {out['rel']:.3e}")


@pytest.mark.gpu
def test_graph_launch_counters_follow_eager_formula():
    """After a run on graphs the launch counters equal the eager per-tick
    formula (replays add what their capture recorded), and every tick after
    a key's build is a replay of it."""
    smoke = _smoke_script()
    cfg = treg.get("smollm-135m-butterfly-smoke").with_(
        compute_dtype="float32")
    dev = torch.device("cuda")
    eng = ServeEngine(cfg, loader.init_params(cfg, seed=0, device=dev),
                      slots=2, max_len=48, device=dev)
    rng = np.random.default_rng(3)
    smoke.zero_launches()
    futs = [eng.submit(Request(prompt=rng.integers(0, cfg.vocab_size, n),
                               max_new_tokens=16)) for n in (5, 23, 11, 3)]
    eng.run_until_idle(max_ticks=1000)
    assert all(len(f.result(0).tokens) == 16 for f in futs)
    snap = eng.metrics.snapshot()
    assert smoke.read_launches() == smoke.serve_launches_want(cfg, snap, True)
    smoke.graph_report(eng, snap, True)


@pytest.mark.gpu
def test_failed_capture_raises_naming_the_key():
    """A step that fails while its graph is captured: the key's first run
    (the eager warm-up) computes, then the capture raises naming the key,
    nothing carries on eagerly, and the launch counters keep what the
    warm-up launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run `pytest -m gpu` on the card)")
    from repro_torch.kernels import sandwich as ks
    from repro_torch.serve.graphs import GraphCache

    def step(x):
        ks.sandwich_forward.launches += 1        # as a kernel wrapper does
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("not capturable")
        return (x * 2,)

    cache = GraphCache(torch.device("cuda"))
    entry = cache.entry(("bad", 1), lambda: (
        step, {"x": torch.ones(4, device="cuda")}))
    before = ks.sandwich_forward.launches
    with pytest.raises(RuntimeError, match=r"capture of bad \| 1 failed"):
        cache.run(entry)
    assert ks.sandwich_forward.launches == before + 1
    assert cache.compiles == 0 and entry.graph is None


@pytest.mark.gpu
def test_capture_survives_host_copies_from_another_thread():
    """A graph build (warm-up + capture) while another thread copies host
    tensors to the card in a loop, as a router's caller does when it swaps
    a checkpoint into one replica while another captures its first graph:
    the capture succeeds and its replay computes the step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run `pytest -m gpu` on the card)")
    import threading

    from repro_torch.serve.graphs import GraphCache

    dev = torch.device("cuda")
    stop, copies, errors = threading.Event(), [0], []
    dst = torch.empty(1 << 20, device=dev)
    src = torch.randn(1 << 20)

    def copier():
        try:
            while not stop.is_set():
                dst.copy_(src)
                copies[0] += 1
        except Exception as e:                 # reported below
            errors.append(e)

    w = torch.randn(256, 256, device=dev)

    def step(x):
        y = x
        for _ in range(50):
            y = torch.tanh(y @ w)
        return (y,)

    cache = GraphCache(dev)
    t = threading.Thread(target=copier, daemon=True)
    t.start()
    try:
        outs = []
        for i in range(5):
            entry = cache.entry(("concurrent", i), lambda: (
                step, {"x": torch.randn(64, 256, device=dev)}))
            first = cache.run(entry)[0].clone()
            outs.append((entry, first))
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    assert copies[0] > 0 and cache.compiles == 5
    for entry, first in outs:
        torch.testing.assert_close(cache.run(entry)[0], first)
    print(f"5 captures beside {copies[0]} host-to-device copies")
