"""The port's speculative decoding (`spec_k > 0`) against the JAX
reference: draft-k-verify-1 through the butterfly head.

Greedy verification commits the full model's own argmax, so a speculative
engine's tokens must equal the non-speculative engine's and the
reference's, for every k, on multi-chunk prompts, under stop tokens and
across preemptions. The traces are those of `tests/test_serve_spec.py`,
in float32 on the CPU, on the reference's weights carried into the port.

Against the reference the engines run the dense smoke arch, and the spec
counters (ticks, drafts, accepted drafts) must equal the reference's too.
The butterfly smoke arch's head at its random init gives the top two
logits exactly equal values at a share of positions
(`test_butterfly_head_ties_top_logits_at_init`): the port computes such a
pair bit for bit alike and takes the lower token, the reference's
sandwich may part it by a last bit, so there the two frameworks' greedy
tokens part at ties, not at faults. On the butterfly head, where the
draft reads out through the sandwich, the port is held against itself:
speculative tokens equal non-speculative ones.
"""

import numpy as np
import pytest
import torch

from repro.serve import SamplingParams as JSamplingParams
from repro.serve import ServeEngine as JServeEngine
from repro_torch.serve import Request, SamplingParams, ServeEngine
from repro_torch.serve import steps as steps_lib
from test_torch_serve_lifecycle import MAX_TICKS, STARVED_KW, Pair, carried
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

SPEC = ("ticks", "draft_tokens", "accepted_draft_tokens")


@pytest.fixture(scope="module")
def models():
    return carried("smollm-135m-smoke")


@pytest.fixture(scope="module")
def bfly_model():
    _, _, tcfg, model = carried("smollm-135m-butterfly-smoke")
    return tcfg, model


def _prompts(cfg, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


def _serve(models, prompts, max_new, **kw):
    pair = Pair(models, **kw)
    for p in prompts:
        pair.submit(p, max_new)
    pair.run()
    snap = pair.check()
    jspec = pair.j.metrics.snapshot()["spec"]
    for key in SPEC:
        assert snap["spec"][key] == jspec[key], (key, snap["spec"], jspec)
    return [t.result(0).tokens for _, t in pair.futs], snap, pair.t


@pytest.mark.parametrize("spec_k", [1, 3])
def test_spec_matches_nonspec_and_reference(models, spec_k):
    """Mixed prompt lengths (one spanning two chunks) through 2 slots: the
    speculative tokens equal the non-speculative engine's and the
    reference's; acceptance is counted; every page recycles."""
    prompts = _prompts(models[0], 21, (5, 9, 20, 7))
    base, _, _ = _serve(models, prompts, 8, slots=2, max_len=64)
    spec, snap, eng = _serve(models, prompts, 8, slots=2, max_len=64,
                             spec_k=spec_k)
    assert prompts[2].size > eng.prefill_chunk       # multi-chunk
    assert spec == base
    sp = snap["spec"]
    assert sp["k"] == spec_k and sp["ticks"] > 0 and sp["draft_tokens"] > 0
    assert sp["acceptance_rate"] == pytest.approx(
        sp["accepted_draft_tokens"] / sp["draft_tokens"], abs=1e-4)
    assert eng.pool.pages_in_use == 0


@pytest.mark.parametrize("spec_k", [1, 3])
def test_spec_on_butterfly_head(bfly_model, spec_k):
    """Drafting through the butterfly head: speculative tokens equal
    non-speculative ones, and at random init the draft accepts often
    enough that a tick commits more than one token per occupied slot."""
    tcfg, model = bfly_model
    prompts = _prompts(tcfg, 22, (5, 23, 37, 11))
    toks = {}
    for k in (0, spec_k):
        eng = ServeEngine(tcfg, model, slots=4, max_len=128, spec_k=k,
                          device="cpu")
        futs = [eng.submit(Request(prompt=p, max_new_tokens=16))
                for p in prompts]
        eng.run_until_idle(max_ticks=MAX_TICKS)
        toks[k] = [f.result(0).tokens for f in futs]
    assert toks[spec_k] == toks[0]
    assert all(len(t) == 16 for t in toks[0])
    sp = eng.metrics.snapshot()["spec"]
    assert sp["accepted_draft_tokens"] > 0
    assert sp["tokens_per_slot_tick"] > 1.0


def test_verify_replay_matches_eager_pass_and_leaves_state(bfly_model):
    """``replay_verify_logits`` (the draft and verify entries) gives the
    logits of the same verify pass run eagerly (``verify_logits``), bit for
    bit on the CPU, and leaves the engine's state as it was: the run it
    interrupts ends on the tokens of a run that was not probed."""
    tcfg, model = bfly_model
    prompts = _prompts(tcfg, 22, (5, 23, 37, 11))
    toks = {}
    for probe in (False, True):
        eng = ServeEngine(tcfg, model, slots=4, max_len=128, spec_k=3,
                          device="cpu")
        futs = [eng.submit(Request(prompt=p, max_new_tokens=12))
                for p in prompts]
        for _ in range(4):
            eng.step()
        if probe:
            tokens, logits = eng.replay_verify_logits()
            assert tokens.shape == (4, 4)
            assert logits.shape == (4, 4, tcfg.vocab_size)
            assert torch.equal(eng.verify_logits(tokens, context="torch"),
                               logits)
        eng.run_until_idle(max_ticks=MAX_TICKS)
        toks[probe] = [f.result(0).tokens for f in futs]
    assert toks[True] == toks[False]


def test_spec_stop_token_truncates_mid_commit(models):
    """A stop token inside an accepted prefix cuts the commit where
    non-speculative decoding stops."""
    jcfg, params, tcfg, model = models
    (prompt,) = _prompts(jcfg, 25, (6,))
    full, _, _ = _serve(models, [prompt], 12, slots=2, max_len=64)
    stop = full[0][len(full[0]) // 2]
    want = full[0][:full[0].index(stop) + 1]
    for k in (0, 1, 2, 4):
        pair = Pair(models, slots=2, max_len=64, spec_k=k)
        pair.submit(prompt, 12, stop_token=stop)
        pair.run()
        pair.check()
        assert pair.futs[0][1].result(0).tokens == want, f"spec_k={k}"


def test_spec_preempt_during_speculation(models):
    """A page-starved incremental pool preempts a slot mid-speculation
    (anchors live, growth covering the draft positions); the recomputed
    request still lands on the reference's tokens."""
    prompts = _prompts(models[0], 24, (5, 5))
    _, snap, eng = _serve(models, prompts, 14, **STARVED_KW, spec_k=2)
    assert snap["preempted"] >= 1 and snap["spec"]["draft_tokens"] > 0
    assert eng.pool.pages_in_use == 0
    assert len(eng.pool.free_list()) == eng.pool.total_pages - 1


def test_spec_builds_once_per_key(models):
    """Speculation adds two entries, draft and verify, each built once
    whatever the prompt lengths, and replaces the pooled decode."""
    prompts = _prompts(models[0], 23, (4, 9, 17, 6, 12))
    _, snap, eng = _serve(models, prompts, 6, slots=2, max_len=64, spec_k=2)
    stats = eng.compile_stats
    kinds = [k[0] for k in stats["traces"]]
    assert sorted(kinds) == ["chunk_prefill", "spec_draft", "spec_verify"]
    assert set(stats["traces"].values()) == {1}
    verify = ("spec_verify", eng.cfg.name, 2, 2)
    assert stats["replays"][verify] == snap["spec"]["ticks"] - 1


def test_spec_constructor_validation(models):
    """Speculation needs greedy sampling and the paged pool with chunked
    prefill; both engines reject anything else, and the step factories
    reject k < 1."""
    jcfg, params, tcfg, model = models
    cases = [(dict(spec_k=-1), "spec_k"),
             (dict(spec_k=2, sampling="hot"), "greedy"),
             (dict(spec_k=2, prefill_chunk=None), "paged")]
    for kw, match in cases:
        j, t = dict(kw), dict(kw)
        if kw.get("sampling"):
            j["sampling"] = JSamplingParams(temperature=0.7)
            t["sampling"] = SamplingParams(temperature=0.7)
        with pytest.raises(ValueError, match=match):
            JServeEngine(jcfg, params, slots=2, max_len=64, **j)
        with pytest.raises(ValueError, match=match):
            ServeEngine(tcfg, model, slots=2, max_len=64, device="cpu", **t)
    with pytest.raises(ValueError, match="paged"):
        JServeEngine(jcfg, params, slots=2, max_len=64, spec_k=2,
                     pool="dense")
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(tcfg, model, slots=2, max_len=64, device="cpu", spec_k=2,
                    pool="dense")
    eng = ServeEngine(tcfg, model, slots=2, max_len=64, device="cpu")
    with pytest.raises(ValueError, match="k >= 1"):
        steps_lib.make_draft_step(model, 0)
    with pytest.raises(ValueError, match="k >= 1"):
        steps_lib.make_spec_decode_step(model, eng.caches, 0)
    fut = eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=2))
    eng.run_until_idle(max_ticks=MAX_TICKS)
    assert len(fut.result(0).tokens) == 2


def test_butterfly_head_ties_top_logits_at_init(bfly_model):
    """Why the parity tests against the reference run the dense arch: at
    its random init the butterfly smoke head gives the top two logits
    exactly equal values at a share of positions. The port computes such a
    pair bit for bit alike and its argmax takes the lower token, so its
    own paths agree at ties; the reference's sandwich sums in another order
    and may part the pair by a last bit. Prints the share found."""
    from repro_torch.models import common as cm
    from repro_torch.models import lm
    tcfg, model = bfly_model
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (5, 40)))
    pos = torch.arange(40, dtype=torch.int32).expand(5, 40)
    with torch.no_grad():
        x = cm.embed(tcfg, model.embed, tokens)
        x, _ = lm.backbone(model, x, positions=pos, context="torch")
        x = cm.rmsnorm(x, model.final_norm, tcfg.norm_eps)
        logits = cm.head_apply(tcfg, model.head, x, "torch").reshape(200, -1)
    top = logits.topk(2, dim=-1)
    tied = top.values[:, 0] == top.values[:, 1]
    print(f"exact top-2 ties at {int(tied.sum())} of {tied.numel()} "
          f"positions")
    assert int(tied.sum()) > 0
    for row in torch.nonzero(tied)[:, 0].tolist():
        best = torch.nonzero(logits[row] == top.values[row, 0])[:, 0]
        assert int(logits[row].argmax()) == int(best.min())
