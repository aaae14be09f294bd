"""The port's serving engine on the zoo's MoE and Gemma archs against the
JAX reference's `ServeEngine`, at smoke size in float32 on the CPU.

The expert capacity depends on the rows of a call (`T`), so every token
of an MoE arch depends on the tick's whole batch: inactive slots, chunk
pad tails and the verify pass's positions compete for expert slots. The
port's ticks must hand the MoE the reference's rows, filler included, and
greedy tokens must then equal the reference's request for request, with
the same lifecycle counters:

* `olmoe-1b-7b-smoke` and `dbrx-132b-smoke` under eager admission,
  incremental admission on a starved pool (a preemption asserted) and
  `spec_k=3`; `gemma-7b-smoke` (tied head) under eager admission;
* each engine first serves fewer prompts than slots (decode rows of idle
  slots compete for capacity, 1 slot an expert at 4 rows), then more
  prompts than slots, some over several chunks.

The carried weights are made once, in a module-scoped fixture; each
reference engine is built once for its case and serves both traces (one
compile per key). The butterfly-smoke variants are held port against port
only (their sandwich head ties its top logits at init,
`test_torch_serve_spec.py::test_butterfly_head_ties_top_logits_at_init`):
at a capacity that drops nothing the MoE is independent of the batch, so
eager, incremental and `spec_k=3` serving give every request the tokens
of its lone run, and at the default capacity the drops show.
"""

import numpy as np
import pytest
import torch

from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import registry as treg
from repro_torch.models import lm as tlm
from repro_torch.serve import Request, ServeEngine
from test_torch_zoo_lm import carried

MAX_TICKS = 400
COUNTERS = ("preempted", "recompute_tokens", "max_concurrent_slots")
BASE = dict(slots=4, max_len=48, page_size=8, prefill_chunk=8)
MODES = {
    "eager": {},
    # 7 usable 8-token pages for four requests of up to 26 positions
    "incremental": dict(admission="incremental", num_pages=8),
    "spec3": dict(spec_k=3),
}
CASES = [("olmoe-1b-7b-smoke", m) for m in MODES] + \
        [("dbrx-132b-smoke", m) for m in MODES] + \
        [("gemma-7b-smoke", "eager")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under the
    suite's parallel workers the threads only contend: this module runs on
    one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _traces(vocab):
    """(few, many): 2 prompts into 4 slots, then 6 prompts of 3-19 tokens
    (up to three 8-token chunks), 12 new tokens each."""
    rng = np.random.default_rng(7)
    few = [rng.integers(0, vocab, n).astype(np.int32) for n in (5, 11)]
    many = [rng.integers(0, vocab, n).astype(np.int32)
            for n in (19, 3, 9, 14, 6, 17)]
    return few, many


@pytest.fixture(scope="module")
def carried_archs():
    return {arch: carried(arch) for arch in
            ("olmoe-1b-7b-smoke", "dbrx-132b-smoke", "gemma-7b-smoke")}


def _serve(engine, request_cls, prompts, new=12):
    futs = [engine.submit(request_cls(prompt=p, max_new_tokens=new))
            for p in prompts]
    engine.run_until_idle(max_ticks=MAX_TICKS)
    return [f.result(timeout=0).tokens for f in futs]


@pytest.mark.parametrize("arch,mode", CASES)
def test_greedy_tokens_equal_reference(carried_archs, arch, mode):
    jcfg, params, tcfg, model = carried_archs[arch]
    kw = {**BASE, **MODES[mode]}
    j = JServeEngine(jcfg, params, seed=0, **kw)
    t = ServeEngine(tcfg, model, seed=0, device="cpu", **kw)
    for prompts in _traces(jcfg.vocab_size):
        want = _serve(j, JRequest, prompts)
        got = _serve(t, Request, prompts)
        assert got == want
        js, ts = j.metrics.snapshot(), t.metrics.snapshot()
        for key in COUNTERS:
            assert ts[key] == js[key], (key, ts[key], js[key])
        if mode == "spec3":
            assert ts["spec"]["ticks"] > 0
            assert ts["spec"]["draft_tokens"] == js["spec"]["draft_tokens"]
    if mode == "incremental":
        assert ts["preempted"] >= 1
    assert t.pool.pages_in_use == 0


def _bfly(arch, **kw):
    cfg = treg.get(arch).with_(compute_dtype="float32", **kw)
    return cfg, tlm.LM(cfg, generator=torch.Generator().manual_seed(0))


def test_butterfly_moe_serving_port_against_port():
    """`olmoe-1b-7b-butterfly-smoke` at a capacity factor that drops no
    token (capacity >= T): eager, incremental on the starved pool and
    `spec_k=3` give every request the tokens it gets served alone. At the
    arch's own capacity (same weights) the trace runs twice to the same
    tokens, and some request's tokens differ from its lone run: the drops
    make the batch part of the function."""
    prompts = _traces(512)[1]
    cfg, model = _bfly("olmoe-1b-7b-butterfly-smoke", capacity_factor=4.0)
    runs = {m: _serve(ServeEngine(cfg, model, seed=0, device="cpu",
                                  **{**BASE, **kw}), Request, prompts)
            for m, kw in MODES.items()}
    alone = [_serve(ServeEngine(cfg, model, seed=0, device="cpu", **BASE),
                    Request, [p])[0] for p in prompts]
    for mode, toks in runs.items():
        assert toks == alone, mode

    cfg, model = _bfly("olmoe-1b-7b-butterfly-smoke")
    eng = ServeEngine(cfg, model, seed=0, device="cpu", **BASE)
    first = _serve(eng, Request, prompts)
    assert _serve(eng, Request, prompts) == first
    assert first != alone
