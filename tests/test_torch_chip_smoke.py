"""Rehearsal of `chip_smoke.py` on the CPU: every phase after the build
(the sandwich factor and forward checks, serving on the graph cache's
eager CPU entries and its greedy-token checks under eager and incremental
admission, speculative decoding and two replicas behind the router with a
torn-checkpoint swap, the full-width-shaped incremental and speculative
runs, the serving CLI's two-replica tier with and without a tracer,
the sandwich backward and factor-VJP checks, the wide-width checks at
100 -> 36, training and its gradient check, the butterfly kernels' checks,
the encoder-decoder at 64 x 256, the flash kernels' checks at small shapes
and the benches at n = 64) runs on the
smoke-sized butterfly config with the plain PyTorch versions in place of
the kernels, so wrong paths, shapes and control flow show up before the
script reaches a card. Also the script's refusals: no result
and a non-zero exit without a CUDA device, or alone in a directory."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core.layers import ButterflySpec

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SCRIPT = os.path.join(ROOT, "chip_smoke.py")
KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


def _load_script():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _call_once(torch_mod, fn, reps, warm=0):
    """Stand-in for the script's CUDA-event timer: runs ``fn`` once and
    reports no time (the rehearsal measures nothing)."""
    fn()
    return 0.0


def test_rehearsal_runs_every_phase_on_cpu(capsys):
    smoke = _load_script()
    cfg = registry.get("smollm-135m-butterfly-smoke")
    flash_shapes = (("window", 1, 2, 33, 8, ("float32",), False, 24),
                    ("wide", 1, 1, 9, 192, ("float32",), True, 4))
    kernels = smoke.run(torch, np, cfg, torch.device("cpu"), kernel="torch",
                        time_fn=_call_once, train_shape=(64, 2),
                        encdec_shape=(64, 256, 4), encdec_steps=(3, 2),
                        bfly_shapes=(("small", 5, 64), ("ragged", 37, 128)),
                        flash_shapes=flash_shapes,
                        flash_timed=("window",),
                        bench=dict(ns=(64,), batch=4, iters=1),
                        wide=("wide", 100, 36),
                        cli=dict(replicas=2, slots=2, max_len=64,
                                 requests=4, min_prompt=5, max_prompt=20,
                                 max_new=4, rate=50.0))
    out = capsys.readouterr().out
    assert "serve: 16 requests" in out and "on graphs (2 built)" in out
    assert "decode tick replay vs eager (torch)" in out
    assert "graph decode | smollm-135m-butterfly-smoke | 8 | " in out
    assert "graph chunk_prefill | smollm-135m-butterfly-smoke | 8 | 16: " \
        "captures 1, replays 31" in out
    for mode in ("eager", "incremental", "spec", "router"):
        assert f"serve tokens {mode}: " in out
    assert out.count("give the same greedy tokens (64 tokens") == 3
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
    assert "tokens equal to the eager admission run" in out
    assert "verify tick replay vs eager (torch), bfloat16, (8, 4) tokens" \
        in out
    assert "graph spec_draft | smollm-135m-butterfly-smoke | 8 | 3: " \
        "captures 1, replays" in out
    assert "serve spec_k=3: " in out and "acceptance " in out
    assert out.count("tokens equal to the eager admission run") == 2
    assert "sandwich_bwd wide 100->36 (n1 128, n2 64, k 7/5) rows=64 " \
        "bfloat16" in out
    assert "sandwich factors vjp lm_head  max|err|" in out
    assert "dense backward" in out
    for site in ("up_gate", "down", "lm_head", "widest"):
        for dtype in ("float32", "bfloat16"):
            assert f"sandwich factors {site:8s} {dtype:9s} F_in" in out
    assert "sandwich factors widest   bfloat16  F_in (5, 32) F_out (18, " \
        "262144)" in out
    assert "time sandwich lm_head  rows=8" in out
    assert "rows=128: kernels" in out and "bound" in out
    assert "per train step's forward at 128 rows" in out
    assert "train: losses" in out
    assert (f"cotangents: {3 * (3 * cfg.n_layers + 1)} butterfly leaves"
            in out)
    assert "butterfly ragged 37x128 Bt bfloat16" in out
    assert "encdec two_phase/k4: thm1_prediction=" in out
    assert "encdec kernels vs plain: gradient" in out
    assert "flash wide B=1 H=1 S=9 D=192 float32 causal=True window=4" in out
    assert "FlashFn train bfloat16 through autograd" in out
    assert ("bench: backward/flash_fwdbwd_fused_n64,,status=skipped;"
            "reason=no_cuda" in out)
    assert "time flash_bwd_dkv window B=1 H=2 S=33 D=8 float32" in out
    for row in ("kernel/butterfly_n64", "speed/train_n64",
                "backward/sandwich_fwdbwd_fused_n64",
                "backward/flash_fwdbwd_fused_n64"):
        assert f"bench {row} kernels vs plain, float32" in out
    assert "flash train B=2 H=4 S=64 D=16 bfloat16 causal=True" in out
    assert "time attention train B=2 S=64 4 heads (2 KV)" in out
    assert [k["name"] for k in kernels] == [
        "sandwich_fwd (sandwich_factors + sandwich_rows)",
        "paged_decode_attention", "sandwich_bwd",
        "butterfly_fwd", "butterfly_bwd", "flash_fwd", "flash_bwd_dq",
        "flash_bwd_dkv"]
    assert kernels[0]["library_ms"] == 0.0
    assert kernels[0]["train_bound_ms"] > kernels[0]["bound_ms"] > 0
    assert {"serve", "router", "train"} <= \
        kernels[0]["launches_by_path"].keys()
    assert set(kernels[1]["launches_by_path"]) == {"serve", "router"}
    assert kernels[3]["library_ms"] == 0.0 and kernels[4]["library_ms"] is None
    # sdpa's backward stands once, on dq, for the dq/dkv pair
    assert [k["library_ms"] for k in kernels[5:]] == [0.0, 0.0, None]
    assert {k["name"]: set(k["launches_by_path"]) for k in kernels[3:]} == {
        "butterfly_fwd": {"encdec"}, "butterfly_bwd": {"encdec"},
        "flash_fwd": {"bench"}, "flash_bwd_dq": {"bench"},
        "flash_bwd_dkv": {"bench"}}
    assert [k["replaces"] for k in kernels[5:]] == [
        f"src/repro/kernels/flash.py:{n}" for n in (69, 101, 130)]
    for k in kernels:
        assert KEYS <= set(k)
        assert k["launches"] == 0          # plain versions launch nothing
        assert k["max_abs_err"] == 0.0     # plain vs plain
        assert k["bound_by"] in ("bytes", "operations")
        assert k["bound_ms"] > 0
        assert os.path.exists(os.path.join(ROOT, k["source"]))
    json.dumps({"kernels": kernels})


@pytest.mark.parametrize("case", ["dense", "by_hand"])
def test_sandwich_op_counts(case):
    """The bounds' operation counts: on a dense support they are the dense
    formula (3 ops per element and stage forward; backward 3 recompute, 3
    dual, 4 for the two weight products, less the output chain's last
    recompute; the core 2·k1·k2 forward and 4·k1·k2 backward, and the
    scales), and a 2-wide sandwich with one selected and one scattered
    value is counted by hand."""
    smoke = _load_script()
    if case == "dense":
        n1, n2, p1, p2 = 16, 32, 4, 5
        spec = ButterflySpec(n_in=n1, n_out=n2, k_in=n1, k_out=n2,
                             idx_in=tuple(range(n1)),
                             idx_out=tuple(range(n2)))
        want = (3 * (p1 * n1 + p2 * n2) + 2 * n1 * n2 + n1 + n2,
                10 * (p1 * n1 + p2 * n2) - 3 * n2 + 6 * n1 * n2
                + 2 * (n1 + n2))
    else:
        # forward: out[0] of the input stage 3, core and scales 4, the
        # output stage from one nonzero 2; backward: that input stage 3,
        # core forward 4 and backward 6, the output dual stage at idx_out 3
        # and its two weight products 4, the input dual stage from one
        # nonzero 2 and its two weight products 4
        spec = ButterflySpec(n_in=2, n_out=2, k_in=1, k_out=1, idx_in=(0,),
                             idx_out=(1,))
        want = (9, 26)
    assert smoke.sandwich_ops(spec) == want


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0), (False, 5)])
def test_flash_bound_counts_the_visible_pairs(causal, window):
    """The flash bounds count the entries the mask keeps, and per kernel
    4·D, 6·D and 8·D operations per entry."""
    from repro_torch.kernels import flash as kf
    smoke = _load_script()
    S = 13
    pairs = int(kf.visible_mask(S, causal, window).sum())
    assert smoke.flash_pairs(S, causal, window) == pairs
    shape = ("x", 2, 3, S, 8, ("bfloat16",), causal, window)
    b = smoke.flash_bound(shape, "bfloat16")
    arr, rows = 2 * 3 * S * 8 * 2, 2 * 3 * S * 4
    assert b == {"flash_fwd": (4 * arr + rows, 4 * 8 * 6 * pairs),
                 "flash_bwd_dq": (5 * arr + 2 * rows, 6 * 8 * 6 * pairs),
                 "flash_bwd_dkv": (6 * arr + 2 * rows, 8 * 8 * 6 * pairs)}


def test_bench_launch_counts_follow_the_timed_calls():
    """What each kernel must have launched for the bench rows' timed calls:
    a ``kernel/*`` call one butterfly forward, a ``speed/forward`` call one
    sandwich forward (2 launches: factors, rows), a ``speed/train`` call one
    sandwich forward and one backward (6 launches), each fused
    ``backward/*`` call one forward and one backward of its op; plain and
    skipped rows nothing."""
    smoke = _load_script()
    calls = {"kernel/butterfly_n256": 23, "speed/forward_n512": 23,
             "speed/train_n512": 23, "backward/butterfly_fwdbwd_jnp_n1024": 23,
             "backward/butterfly_fwdbwd_fused_n1024": 23,
             "backward/sandwich_fwdbwd_fused_n1024": 23,
             "backward/sandwich_fwdbwd_fused_n8192": 8,
             "backward/flash_fwdbwd_jnp_n8192": 8,
             "backward/flash_fwdbwd_fused_n8192": 8}
    rows = [{"name": n, "calls": c} for n, c in calls.items()]
    assert smoke.bench_want(rows, on_card=True) == {
        "butterfly_fwd": 46, "butterfly_bwd": 46, "sandwich_fwd": 154,
        "sandwich_bwd": 324, "flash_fwd": 8, "flash_bwd": 16}
    assert set(smoke.bench_want(rows, on_card=False).values()) == {0}


@pytest.mark.parametrize("alone", [False, True])
def test_script_refuses_without_card_or_repo(tmp_path, alone):
    script = SCRIPT
    if alone:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SCRIPT, script)
    proc = subprocess.run([sys.executable, script], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
