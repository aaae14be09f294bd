"""Rehearsal of `chip_smoke.py` on the CPU, the serving group of phases:
serving on the graph cache's eager CPU entries and its greedy-token checks
under eager and incremental admission, speculative decoding and two
replicas behind the router with a torn-checkpoint swap, phase 6e's dense
pool, the full-width-shaped incremental and speculative runs, the serving
CLI's two-replica tier with and without a tracer, and the forward kernels'
timing; the plain PyTorch versions stand in for the kernels."""

from test_torch_chip_smoke import check_entries, rehearse
from test_torch_chip_smoke import one_torch_thread  # noqa: F401


def test_rehearsal_serving(capsys):
    _, kernels, out = rehearse(capsys, "serve")
    assert "serve: 16 requests" in out and "on graphs (2 built)" in out
    assert "decode tick replay vs eager (torch)" in out
    assert "graph decode | smollm-135m-butterfly-smoke | 8 | " in out
    assert "graph chunk_prefill | smollm-135m-butterfly-smoke | 8 | 16: " \
        "captures 1, replays 31" in out
    for mode in ("eager", "incremental", "spec", "router"):
        assert f"serve tokens {mode}: " in out
    # smollm's three cases (phase 6a); the zoo's are their group's
    assert out.count("give the same greedy tokens (64 tokens") == 3
    # phase 6e: phase 6's requests on the dense pool, whole prompts
    head = "serve smollm-135m-butterfly-smoke dense:"
    assert (f"{head} 16 requests, prompts 5-200 tokens, 62 ticks (0 chunk, "
            f"62 decode)") in out
    assert "pool dense, max_len 512, whole-prompt prefill" in out
    assert f"{head} whole-prompt prefill ms by prompt length" in out
    assert "graph decode | smollm-135m-butterfly-smoke | 8 | dense | " in out
    assert ("into 2 slots (two replicas behind a Router, a torn-checkpoint "
            "swap on replica 0 mid-run, the prompts twice), chunks of 16, "
            "16 new tokens each: kernels on cpu and plain on the CPU give "
            "the same greedy tokens (128 tokens") in out
    for n, label in enumerate(("null", "tracer", "tracer", "null")):
        assert (f"serve cli run {n} ({label}): [serve] router: 4 requests "
                f"over 2 replicas") in out
        assert f"serve cli run {n} ({label}): TTFT p50 " in out
    assert "serve cli run 2 (tracer): trace " in out
    assert ("serve cli: smollm-135m-butterfly-smoke bfloat16, 2 replicas x 2 "
            "slots, 4 requests of 5-20 prompt tokens") in out
    assert "serve cli: decode tok/s with a tracer " in out
    assert "tokens; preempted 2, spec ticks 0;" in out
    assert "serve incremental: 40 usable pages" in out
    assert "verify tick replay vs eager (torch), bfloat16, (8, 4) tokens" \
        in out
    assert "graph spec_draft | smollm-135m-butterfly-smoke | 8 | 3: " \
        "captures 1, replays" in out
    assert "serve spec_k=3: " in out and "acceptance " in out
    assert out.count("tokens equal to the eager admission run") == 2
    assert "time sandwich lm_head  rows=8" in out
    assert "rows=128: kernels" in out and "bound" in out
    assert "per train step's forward at 128 rows" in out
    fwd, paged = (kernels["sandwich_fwd (sandwich_factors + sandwich_rows)"],
                  kernels["paged_decode_attention"])
    assert list(kernels) == [fwd["name"], paged["name"]]
    assert fwd["library_ms"] == 0.0
    assert fwd["train_bound_ms"] > fwd["bound_ms"] > 0
    assert set(fwd["launches_by_path"]) == {"serve", "router", "serve dense"}
    assert set(paged["launches_by_path"]) == {"serve", "router"}
    check_entries(kernels, kernels)
