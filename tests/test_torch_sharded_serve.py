"""The port's sharded serving engine on two CPU ranks against the JAX
reference's unsharded engine.

Two gloo ranks (`repro_torch.runtime.dist.spawn_ranks`, spawned once for
the module on a thread, one torch thread a rank, the control group's
collectives bounded at `GROUP_TIMEOUT` seconds so that a divergence fails
a test instead of hanging the suite) each build the same engines over a
`(2,)` data mesh from the reference's weights (`repro_torch.convert`);
rank 0 plays each case's script through its
`repro_torch.serve.mesh_serve.MeshServe` and rank 1 follows
(`tests/_torch_mesh_ranks.py:serve_cases`). Meanwhile this process runs
the reference's unsharded `ServeEngine` (the reference's own sharded
engine test fails on the reference, ROADMAP queue 3) and, where the
butterfly head's exact top-2 ties part the two frameworks, the port's
unsharded engine. All in float32 on `smollm-135m-butterfly-smoke`:

* the reference test's own trace (`tests/test_serve.py:697-725`: slots 2,
  max_len 48, prompts of 5, 9 and 20 from `default_rng(6)`, 5 new tokens)
  on the paged pool with chunked prefill;
* the dense pool at 3 slots (whole-prompt admission: a 1-row head and
  3-row decode ticks, which do not split evenly over 2 ranks);
* incremental admission with a preemption (4 usable 8-token pages; its
  counters against the reference, its tokens port against port, and the
  logits where the reference's tokens part from them shown to be a
  top-2 tie within a float32 spacing in both frameworks);
* `spec_k=3`, port against port;
* a trace with a cancel and a `deadline_s`;
* a router of 2 replicas under a drain (requeue), a hot swap from the
  reference's checkpoints (its newest torn), and a replica's death (an
  injected `engine.tick` fault).

Every case holds both ranks' outcomes, tick counts and counters equal,
and the logits every rank sampled from bit for bit equal (the sampled
tokens are not broadcast: ROADMAP's decisions).
"""

import concurrent.futures

import jax
import numpy as np
import pytest

from repro.checkpoint.checkpointing import CheckpointManager as JCkpt
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.faults import tear_checkpoint as jtear
from repro_torch.runtime import dist as rdist
from repro_torch.serve import Request, ServeEngine
from test_torch_chip_smoke import one_torch_thread  # noqa: F401
from test_torch_serve_lifecycle import STARVED_KW, carried

ARCH = "smollm-135m-butterfly-smoke"
GROUP_TIMEOUT = 120.0
SPAWN_TIMEOUT = 600.0
BASE_KW = dict(slots=2, max_len=48)


def _prompts(vocab, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _cases(vocab, ckpt):
    trace = _prompts(vocab, 6, (5, 9, 20))
    starved = _prompts(vocab, 11, (5, 5))
    mixed = _prompts(vocab, 7, (6, 17, 3, 11, 8, 14))

    def subs(prompts, max_new, kw=None):
        return [("submit", p.tolist(), max_new, dict(kw or {}))
                for p in prompts]

    return {
        "paged": dict(replicas=1, kw=BASE_KW, script=subs(trace, 5)),
        "dense": dict(replicas=1, kw=dict(slots=3, max_len=48,
                                          pool="dense"),
                      script=subs(trace, 5)),
        "incremental": dict(replicas=1, kw=STARVED_KW,
                            script=subs(starved, 14)),
        "spec": dict(replicas=1, kw=dict(BASE_KW, spec_k=3),
                     script=subs(trace, 5)),
        "lifecycle": dict(
            replicas=1, kw=BASE_KW,
            script=subs(trace, 5) + [
                ("submit", trace[0].tolist(), 30, {"deadline_s": 0.05}),
                ("step", 2), ("cancel", 1)]),
        "router": dict(replicas=2, kw=BASE_KW,
                       script=subs(mixed[:4], 5) + [
                           ("step", 1), ("drain", 1)] + subs(mixed[4:], 5)
                       + [("step", 2), ("undrain", 1)]),
        "router_swap": dict(replicas=2, kw=BASE_KW,
                            script=subs(mixed[:4], 5) + [
                                ("step", 1), ("swap_checkpoint", 1, ckpt)]
                            + subs(mixed[4:], 5)),
        "router_death": dict(replicas=2, kw=BASE_KW,
                             faults={1: {"engine.tick": [3]}},
                             script=subs(mixed, 5)),
    }


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(cases, each rank's results, the reference's and the port's
    unsharded tokens)."""
    jcfg, params, tcfg, model = carried(ARCH)
    # the reference's checkpoints of the same weights, its newest torn
    ckpt = str(tmp_path_factory.mktemp("mesh_swap"))
    mgr = JCkpt(ckpt)
    mgr.save(1, {"params": params})
    mgr.save(2, {"params": params})
    jtear(ckpt)
    from test_torch_lm import reference_site_specs
    from repro_torch import convert
    specs = {k: convert.butterfly_spec_from_jax(s)
             for k, s in reference_site_specs(jcfg).items()}
    params_np = jax.tree_util.tree_map(np.asarray, params)
    cases = _cases(jcfg.vocab_size, ckpt)
    names = list(cases)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            rdist.spawn_ranks, 2, _ranks().serve_cases, tcfg, params_np,
            specs, [cases[n] for n in names], GROUP_TIMEOUT, device="cpu",
            threads=1, timeout=SPAWN_TIMEOUT, group_timeout=GROUP_TIMEOUT)
        want = {}
        for name in ("paged", "incremental", "router"):
            case = cases[name]
            kw = case["kw"]
            if name == "router":
                kw = BASE_KW
            eng = JServeEngine(jcfg, params, seed=0, **kw)
            futs = [eng.submit(JRequest(prompt=np.asarray(a[1], np.int32),
                                        max_new_tokens=a[2]))
                    for a in case["script"] if a[0] == "submit"]
            eng.run_until_idle(max_ticks=400)
            want[name] = [f.result(0).tokens for f in futs]
            want[name + "_snapshot"] = eng.metrics.snapshot()
        eng = JServeEngine(jcfg, params, seed=0, **cases["dense"]["kw"])
        futs = [eng.submit(JRequest(prompt=np.asarray(a[1], np.int32),
                                    max_new_tokens=a[2]))
                for a in cases["dense"]["script"]]
        eng.run_until_idle(max_ticks=400)
        want["dense_reference"] = [f.result(0).tokens for f in futs]
        for name in ("dense", "spec", "paged", "incremental"):
            eng = ServeEngine(tcfg, model, seed=0, device="cpu",
                              **cases[name]["kw"])
            futs = [eng.submit(Request(prompt=a[1], max_new_tokens=a[2]))
                    for a in cases[name]["script"]]
            eng.run_until_idle(max_ticks=400)
            want["port_" + name] = [f.result(0).tokens for f in futs]
        want["incremental_splits"] = _splits(
            jcfg, params, tcfg, model, cases["incremental"]["script"],
            want["incremental"], want["port_incremental"])
        got = ranks.result()
    return cases, {n: [r[i] for r in got] for i, n in enumerate(names)}, \
        want


def _splits(jcfg, params, tcfg, model, script, ref, port):
    """Where the reference's and the port's tokens of each request part:
    ``(request, token index, reference's token, port's token, the
    reference's logits of the two, the port's, the spacing of float32 at
    the larger, each framework's largest logit, the reference's argmax)``,
    the logits of the whole prompt and the agreed tokens before the
    split, last position, in each framework."""
    import jax.numpy as jnp
    import torch
    from repro.models import lm as jlm
    from repro_torch.models import lm as tlm
    from repro_torch.serve import cache as sc
    out = []
    max_len = STARVED_KW["max_len"]
    for i, (a, b) in enumerate(zip(ref, port)):
        a, b = list(a), list(b)
        d = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if d is None:
            continue
        seq = np.asarray(script[i][1] + a[:d], np.int32)[None]
        jl = np.asarray(jax.jit(lambda p, t: jlm.prefill(
            jcfg, p, {"tokens": t}, jlm.init_caches(jcfg, 1, max_len)))(
                params, jnp.asarray(seq))[0])[0]
        with torch.no_grad():
            tl = tlm.prefill(model, torch.from_numpy(seq).long(),
                             sc.init_caches(tcfg, 1, max_len, device="cpu"),
                             context="torch")[0].numpy()
        out.append((i, d, a[d], b[d], (float(jl[a[d]]), float(jl[b[d]])),
                    (float(tl[a[d]]), float(tl[b[d]])),
                    float(np.spacing(np.float32(max(jl.max(), tl.max())))),
                    (float(jl.max()), float(tl.max())), int(jl.argmax())))
    return out


def _ranks():
    import _torch_mesh_ranks
    return _torch_mesh_ranks


def _agree(per_rank):
    """Both ranks' readings equal; returns rank 0's."""
    r0, r1 = per_rank
    for key in ("outcomes", "ticks", "mirror_ticks", "counters", "logits",
                "sampled", "dead", "swaps"):
        assert r0[key] == r1[key], (key, r0[key], r1[key])
    assert r0["layout"] == "data=2" and not r0["captures"]
    assert r0["errors"] == r1["errors"] == []
    return r0


@pytest.mark.parametrize("name", ["paged", "dense", "incremental", "spec",
                                  "lifecycle", "router", "router_swap",
                                  "router_death"])
def test_ranks_agree_and_sample_identical_logits(served, name):
    """Every case: the ranks' outcomes, ticks, counters and the digest of
    every logits tensor they sampled from are equal, and the mesh gathered
    rows (the sites ran sharded)."""
    _, got, _ = served
    r0 = _agree(got[name])
    assert r0["sampled"] > 0 and r0["gathers"] > 0


def test_paged_trace_matches_the_unsharded_reference(served):
    """The reference test's trace on the paged pool with chunked prefill
    (the 20-token prompt spans two chunks): token for token the reference
    engine's, unsharded."""
    _, got, want = served
    r0 = _agree(got["paged"])
    assert r0["outcomes"] == want["paged"] == want["port_paged"]


def test_dense_pool_matches_the_unsharded_engines(served):
    """Whole-prompt admission on the dense pool at 3 slots (1-row head
    calls and 3-row decode ticks padded to 4 over the 2 ranks): the
    port's unsharded dense engine's tokens and the reference's paged
    engine's. The reference's own dense engine parts from its paged one
    on this trace (request 0's fourth token: ROADMAP queue 3); the port's
    pools agree."""
    _, got, want = served
    r0 = _agree(got["dense"])
    assert r0["outcomes"] == want["port_dense"] == want["paged"]
    print(f"reference dense {want['dense_reference']} vs its paged "
          f"{want['paged']}")


def test_incremental_admission_preempts_as_the_reference(served):
    """Two requests on 4 usable pages: the younger is preempted and
    recomputed on both ranks alike, as often and with as many recomputed
    tokens as in the reference's engine. Tokens are the port's unsharded
    engine's: 14 greedy tokens through the butterfly head meet a top-2
    tie at init that the reference breaks the other way by a last bit
    (each request's seventh token; the next test holds the logits there;
    ROADMAP queue 3)."""
    _, got, want = served
    r0 = _agree(got["incremental"])
    assert r0["outcomes"] == want["port_incremental"]
    ref = want["incremental_snapshot"]
    assert r0["counters"][0]["preempted"] == ref["preempted"] >= 1
    assert r0["counters"][0]["recompute_tokens"] == ref["recompute_tokens"]


def test_incremental_split_from_the_reference_is_a_last_bit_tie(served):
    """Why the incremental case's tokens are held port against port: where
    the reference's greedy tokens part from the port's, the two tokens
    picked are the top two logits of both frameworks at that prefix, the
    port's bit for bit equal (its argmax takes the lower token, which it
    picks) and the reference's at most one float32 spacing apart (which
    of the pair wins there turns on the last bit: the reference's own
    whole-prompt forward picks the port's token). Every token before the
    split is equal. Prints each split's logits."""
    _, _, want = served
    splits = want["incremental_splits"]
    for i, d, ref_tok, port_tok, ref_l, port_l, ulp, tops, ref_argmax \
            in splits:
        print(f"request {i} token {d}: reference picks {ref_tok}, port "
              f"{port_tok}; reference logits {ref_l!r}, port {port_l!r}, "
              f"float32 spacing {ulp!r}")
        assert want["incremental"][i][:d] == want["port_incremental"][i][:d]
        assert port_l[0] == port_l[1] == tops[1]
        assert port_tok == min(ref_tok, port_tok)
        assert abs(ref_l[0] - ref_l[1]) <= ulp
        assert max(ref_l) == tops[0] and ref_argmax == port_tok
    for i, (a, b) in enumerate(zip(want["incremental"],
                                   want["port_incremental"])):
        if i not in {s[0] for s in splits}:
            assert list(a) == list(b)


def test_speculative_decoding_matches_the_unsharded_port(served):
    """``spec_k=3`` through the butterfly head: the port's unsharded
    speculative engine's tokens (the head's exact top-2 ties keep the
    reference out: ROADMAP queue 3), which are its non-speculative ones."""
    _, got, want = served
    r0 = _agree(got["spec"])
    assert r0["outcomes"] == want["port_spec"] == want["port_paged"]


def test_cancel_and_deadline_agree_across_ranks(served):
    """A cancel after two ticks and a 50 ms ``deadline_s`` on a 30-token
    request: both ranks fail the same requests the same way (the deadline
    judged against rank 0's clock reading, the submit time rank 0's)."""
    _, got, want = served
    r0 = _agree(got["lifecycle"])
    out = r0["outcomes"]
    assert out[1] == "RequestCancelled" and out[3] == "DeadlineExceeded"
    assert out[0] == want["paged"][0] and out[2] == want["paged"][2]
    counters = r0["counters"][0]
    assert counters["cancelled"] == counters["deadline_expired"] == 1


def test_router_replicas_share_the_mesh(served):
    """Two replicas behind the router, each on the mesh: a drain after the
    first pass requeues replica 1's queued requests, later submits go to
    replica 0 until the undrain; every request's tokens equal the
    reference's unsharded engine's, on both ranks."""
    _, got, want = served
    r0 = _agree(got["router"])
    assert r0["outcomes"] == want["router"]
    assert all(t > 0 for t in r0["ticks"])


def test_router_hot_swap_on_the_mesh(served):
    """A hot swap of replica 1 mid-flight: drained (its queue requeued,
    its in-flight requests finished, ticks driven by rank 0), the newest
    valid checkpoint restored on every rank (step 2 is torn: step 1), the
    weights copied in, undrained; the later submits reach it again, and
    every request's tokens equal the reference's."""
    _, got, want = served
    r0 = _agree(got["router_swap"])
    assert r0["swaps"] == 1
    assert r0["outcomes"] == want["router"]


def test_router_replica_death_agrees_across_ranks(served):
    """Replica 1's third tick raises an injected fault on both ranks: it
    dies on both, its in-flight requests fail with the fault, its queued
    ones requeue onto replica 0, and every finished request's tokens
    equal the reference's."""
    _, got, want = served
    r0 = _agree(got["router_death"])
    assert r0["dead"] == [False, True]
    failed = [o for o in r0["outcomes"] if isinstance(o, str)]
    assert failed and set(failed) == {"InjectedFault"}
    for o, w in zip(r0["outcomes"], want["router"]):
        assert isinstance(o, str) or o == w
