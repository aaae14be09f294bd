"""Rehearsal of `chip_smoke.py` on the CPU: every phase after the build
(the sandwich factor and forward checks, serving on the graph cache's
eager CPU entries and its greedy-token checks under eager and incremental
admission, speculative decoding and two replicas behind the router with a
torn-checkpoint swap, the full-width-shaped incremental and speculative
runs, the serving CLI's two-replica tier with and without a tracer,
the sandwich backward and factor-VJP checks, the wide-width checks at
100 -> 36, training and its gradient check, the butterfly kernels' checks,
the encoder-decoder at 64 x 256, the flash kernels' checks at small shapes,
the benches at n = 64, the layer API at 64 -> 96 and 64 x 64, the learned
sketch at 64 x 48, the paper's rows at 2 steps, the training CLI's
continuous, resumed and compressed runs with the execution context's
checks, and the zoo's phases: the paged kernel at the four zoo shapes,
the sandwich at a small zoo site, the OLMoE and Gemma butterfly smoke
configs served, the MoE trained one step and its greedy tokens, gemma3's
rings served, trained and its tokens, and the recurrent archs' smoke
configs served on the dense pool, trained and their tokens with 1- and
2-token prompts, and the frontend and encoder archs' smoke configs served
with their stub inputs, trained and their tokens on both pools) runs on the smoke-sized butterfly config with the plain
PyTorch versions in place of the kernels, so wrong paths, shapes and
control flow show up before the script reaches a card. Also the script's refusals: no result
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
# the zoo phases at smoke size; the paged kernel's shapes are the zoo's own
ZOO_SMOKE = dict(
    paged=("olmoe-1b-7b", "dbrx-132b", "mistral-large-123b", "gemma-7b",
           "internvl2-1b", "seamless-m4t-medium"),
    sites=(("zoo", 48, 500),), rows=(8, 20),
    serve=("olmoe-1b-7b-butterfly-smoke", "gemma-7b-butterfly-smoke"),
    train=("olmoe-1b-7b-butterfly-smoke", 1, (32, 2), (1, 1)),
    tokens="olmoe-1b-7b-butterfly-smoke", paged_long=("gemma3-27b",),
    windowed=("gemma3-27b-butterfly-smoke",
              dict(pool="paged", max_len=256, long=(40, 60),
                   probe=(5, 12, 15, 16, 17, 30, 40, 60))),
    windowed_train=("gemma3-27b-butterfly-smoke", 8, (32, 2), (1, 1)),
    windowed_tokens=("gemma3-27b-butterfly-smoke", (5, 16, 20, 40), 64),
    recurrent=tuple((arch, dict(pool="dense", max_len=256, long=(40,),
                                probe=None))
                    for arch in ("recurrentgemma-2b-butterfly-smoke",
                                 "xlstm-125m-butterfly-smoke")),
    recurrent_train=(("recurrentgemma-2b-butterfly-smoke", 5, (32, 2),
                      (1, 1)),
                     ("xlstm-125m-butterfly-smoke", 6, (32, 2), (1, 1))),
    profiled_train=("recurrentgemma-2b-butterfly-smoke",),
    recurrent_tokens=(("recurrentgemma-2b-butterfly-smoke",
                       "xlstm-125m-butterfly-smoke"), (1, 2, 3, 20), 64),
    frontends=tuple((arch, dict(pool="paged", max_len=256, long=(),
                                probe=None))
                    for arch in ("internvl2-1b-butterfly-smoke",
                                 "seamless-m4t-medium-butterfly-smoke")),
    frontend_train=(("internvl2-1b-butterfly-smoke", 2, (16, 2), (1, 1)),
                    ("seamless-m4t-medium-butterfly-smoke", 2, (16, 2),
                     (1, 1))),
    frontend_tokens=(("internvl2-1b-butterfly-smoke",
                      "seamless-m4t-medium-butterfly-smoke"),
                     (5, 23, 11, 3), 48))
KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under the
    suite's parallel workers the threads only contend: this module runs on
    one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
                                 max_new=4, rate=50.0),
                        layers=(("up", 64, 96, None, None, 8, True),
                                ("quick", 64, 64, 8, 8, 8, False)),
                        fit=(64, 8, 32, 5),
                        sketch_run=(64, 48, 16, 8, 24, 8, 20),
                        gated=((16, 64),), nonlinear_steps=2, lm_steps=2,
                        zoo=ZOO_SMOKE)
    out = capsys.readouterr().out
    assert "serve: 16 requests" in out and "on graphs (2 built)" in out
    assert "decode tick replay vs eager (torch)" in out
    assert "graph decode | smollm-135m-butterfly-smoke | 8 | " in out
    assert "graph chunk_prefill | smollm-135m-butterfly-smoke | 8 | 16: " \
        "captures 1, replays 31" in out
    for mode in ("eager", "incremental", "spec", "router"):
        assert f"serve tokens {mode}: " in out
    # smollm's and the MoE's three cases each, gemma3's, smollm's dense,
    # the two recurrent archs', the two frontend archs' two each
    assert out.count("give the same greedy tokens (64 tokens") == 14
    assert out.count("olmoe-1b-7b-butterfly-smoke float32, 4 prompts") == 3
    # the zoo: the paged kernel at its four shapes, the sandwich at its
    # sites, both archs served, the MoE trained, the new shapes timed
    for arch, kv, g, d in (("olmoe-1b-7b", 16, 1, 128),
                           ("dbrx-132b", 8, 6, 128),
                           ("mistral-large-123b", 8, 12, 128),
                           ("gemma-7b", 16, 1, 256),
                           ("internvl2-1b", 2, 7, 64),
                           ("seamless-m4t-medium", 16, 1, 64)):
        for dtype in ("float32", "bfloat16"):
            assert f"paged {arch} KV={kv} G={g} D={d} B=8 " \
                f"{(8, kv, g, d)} ps=16 P=32 {dtype}" in out
        assert f"time paged {arch} B=8 P=32" in out
    for rows in (8, 20):
        assert f"sandwich_bwd zoo 48->500 (n1 64, n2 512, k 6/9) " \
            f"rows={rows} bfloat16" in out
    assert "time sandwich zoo 48->500 rows=8 bfloat16: kernels" in out
    for arch in ZOO_SMOKE["serve"]:
        assert f"serve {arch}: init: " in out
        assert f"serve {arch}: 16 requests" in out
        assert f"serve {arch}: phase " in out
        assert f"profile {arch} graphed: device time not measured" in out
    assert "graph decode | olmoe-1b-7b-butterfly-smoke | 8 | " in out
    # phase 6e: phase 6's requests on the dense pool, whole prompts
    head = "serve smollm-135m-butterfly-smoke dense:"
    assert (f"{head} 16 requests, prompts 5-200 tokens, 62 ticks (0 chunk, "
            f"62 decode)") in out
    assert "pool dense, max_len 512, whole-prompt prefill" in out
    assert f"{head} whole-prompt prefill ms by prompt length" in out
    assert "graph decode | smollm-135m-butterfly-smoke | 8 | dense | " in out
    assert "serve dense" in kernels[0]["launches_by_path"]
    # phases 28-29: gemma3 served with rings beside the pages, probed
    # across the wrap, and trained at one unit and the tail
    head = "serve gemma3-27b-butterfly-smoke:"
    assert f"{head} probe tick at positions [6, 13, 16, 17, 18, 31, " \
        f"41, 61] (ring 16)" in out
    assert f"{head} 16 requests, prompts 5-174 tokens" in out
    assert "pool paged, max_len 256, whole-prompt prefill" in out
    assert f"{head} whole-prompt prefill ms by prompt length" in out
    assert "graph decode | gemma3-27b-butterfly-smoke | 8 | paged | " in out
    assert ("train gemma3-27b-butterfly-smoke: 8 of 8 layers; units 1 x "
            "('local', 'local', 'local', 'local', 'local', 'global'), tail "
            "('local', 'local')") in out
    assert ("train: gemma3-27b-butterfly-smoke, 8 layers, seq_len 32 x "
            "batch 2") in out
    for dtype in ("float32", "bfloat16"):
        assert f"paged gemma3-27b KV=16 G=2 D=128 B=8 (8, 16, 2, 128) " \
            f"ps=16 P=128 {dtype}" in out
    assert ("serve tokens eager: gemma3-27b-butterfly-smoke float32, 4 "
            "prompts of (5, 16, 20, 40) tokens into 2 slots, whole prompts "
            "on the paged pool") in out
    for what in ("incremental", "spec_k"):
        assert f"serve tokens gemma3-27b-butterfly-smoke {what}: refused" \
            in out
    assert ("serve tokens dense: smollm-135m-butterfly-smoke float32, 4 "
            "prompts of (5, 23, 11, 3) tokens into 2 slots, whole prompts "
            "on the dense pool") in out
    assert ("train: olmoe-1b-7b-butterfly-smoke, 1 layers, seq_len 32 x "
            "batch 2") in out
    # phases 30-32: the recurrent archs served on the dense pool, trained
    # at all their layers, and their token cases with 1- and 2-token
    # prompts
    for arch, sites_, unit, tail in (
            ("recurrentgemma-2b-butterfly-smoke", 16,
             "('rec', 'rec', 'local')", "('rec', 'rec')"),
            ("xlstm-125m-butterfly-smoke", 1,
             "('mlstm', 'mlstm', 'mlstm', 'mlstm', 'mlstm', 'slstm')", "()")):
        head = f"serve {arch}:"
        assert f"{head} 16 requests, prompts 5-187 tokens" in out
        assert "pool dense, max_len 256, whole-prompt prefill" in out
        assert f"{head} whole-prompt prefill ms by prompt length" in out
        assert f"{head} phase " in out
        assert (f"= 2 x {sites_}/tick x (decode + chunk + whole prefills "
                f"16), 2 x 0/decode tick") in out
        assert f"graph decode | {arch} | 8 | dense | " in out
        assert f"profile {arch} graphed: device time not measured" in out
        n = registry.get(arch).n_layers
        assert (f"train {arch}: {n} of {n} layers; units 1 x {unit}, tail "
                f"{tail}") in out
        assert f"train: {arch}, {n} layers, seq_len 32 x batch 2" in out
        assert (f"serve tokens eager: {arch} float32, 4 prompts of (1, 2, 3, "
                f"20) tokens into 2 slots, whole prompts on the dense pool"
                ) in out
        for what in ("incremental", "spec_k"):
            assert f"serve tokens {arch} {what}: refused" in out
        assert f"serve tokens {arch}: phase " in out
        assert {f"serve {arch}", f"train {arch}"} <= \
            kernels[0]["launches_by_path"].keys()
    # phases 33-35: the vision prefix and the encoder-decoder served on the
    # paged pool with their stub inputs, trained, and their token cases
    for arch, sites_, enc, paged, rows in (
            ("internvl2-1b-butterfly-smoke", 7, "", 2, 48),
            ("seamless-m4t-medium-butterfly-smoke", 5,
             " + 2 x 4 encoder sites x whole prefills", 2, 32)):
        head = f"serve {arch}:"
        assert f"{head} 16 requests, prompts 5-200 tokens" in out
        assert "pool paged, max_len 256, whole-prompt prefill" in out
        assert (f"= 2 x {sites_}/tick x (decode + chunk + whole prefills "
                f"16){enc}, 2 x {paged}/decode tick") in out
        assert f"graph decode | {arch} | 8 | paged | " in out
        assert f"profile {arch} graphed: device time not measured" in out
        assert f"train site {arch} up_gate 64->128 rows={rows}" in out
        assert f"train: {arch}, 2 layers, seq_len 16 x batch 2" in out
        for pool in ("paged", "dense"):
            assert (f"{arch} float32, 4 prompts of (5, 23, 11, 3) tokens "
                    f"into 2 slots, whole prompts on the {pool} pool") in out
        for what in ("incremental", "spec_k"):
            assert f"serve tokens {arch} {what}: refused" in out
        assert {f"serve {arch}", f"train {arch}"} <= \
            kernels[0]["launches_by_path"].keys()
        assert f"serve {arch}" in kernels[1]["launches_by_path"]
    assert ("train site xlstm-125m-butterfly-smoke lm_head 64->512 rows=64 "
            "float32   forward") in out
    assert "train site xlstm-125m-butterfly-smoke up_gate" not in out
    assert "; of which aux " in out
    # the MoE's head held against plain at the training run's rows first
    for dtype in ("float32", "bfloat16"):
        assert (f"train site olmoe-1b-7b-butterfly-smoke lm_head 64->512 "
                f"rows=64 {dtype:9s} forward max|err|=") in out
        assert (f"train site olmoe-1b-7b-butterfly-smoke lm_head rows=64 "
                f"{dtype:9s} backward max|err|") in out
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
    assert ("layer api up 64->96 (k 6/7) rows=8: from_dense forward (torch) "
            "vs to_dense() @ x + bias max|err|") in out
    assert "layer api quickstart fit 64x64 k 8, X 32x64, 5 Adam steps" in out
    assert "layer api quickstart fit forward 32x64 k 8 float32 (torch)" in out
    assert "layer api quickstart fit backward 32x64 k 8 float32 max|err|" \
        in out
    assert "sketch first step (6 x 64x48, ell 16, k 8) through torch" in out
    assert "sketch hyper_like 64x48 x 24+8, ell 16, k 8, batch 6, 20 steps" \
        in out
    assert "profile sketch: not measured (no card)" in out
    assert "gated butterfly 16x64 float32 (tanh GELU) on cpu" in out
    for name in ("linear_target", "mlp_target"):
        assert (f"nonlinear {name} linear arm first step (512 x 64, float32) "
                f"through torch vs the plain twins") in out
    assert ("lm_butterfly first step, smollm-135m-butterfly-smoke seq_len 64 "
            "x batch 8, seed 0:") in out
    assert out.count("train step float32, whole step through all 2 layers") \
        == 2
    for row in ("nonlinear/linear_target", "nonlinear/mlp_target",
                "lm_butterfly/final_loss"):
        assert f"paper: {row},0.00," in out
    assert "dense_params=139584;butterfly_params=83314" in out
    for what in ("layer api quickstart fit", "sketch: phase", "paper rows: "
                 "phase"):
        assert what in out
    assert [k["name"] for k in kernels] == [
        "sandwich_fwd (sandwich_factors + sandwich_rows)",
        "paged_decode_attention", "sandwich_bwd",
        "butterfly_fwd", "butterfly_bwd", "flash_fwd", "flash_bwd_dq",
        "flash_bwd_dkv"]
    assert kernels[0]["library_ms"] == 0.0
    assert kernels[0]["train_bound_ms"] > kernels[0]["bound_ms"] > 0
    assert {"serve", "router", "train", "layer_api", "lm_butterfly"} <= \
        kernels[0]["launches_by_path"].keys()
    assert {"train", "train_cli", "layer_api", "lm_butterfly",
            "train olmoe-1b-7b-butterfly-smoke",
            "train gemma3-27b-butterfly-smoke",
            "train recurrentgemma-2b-butterfly-smoke",
            "train xlstm-125m-butterfly-smoke",
            "train internvl2-1b-butterfly-smoke",
            "train seamless-m4t-medium-butterfly-smoke"} == \
        kernels[2]["launches_by_path"].keys()
    assert {"serve olmoe-1b-7b-butterfly-smoke",
            "serve gemma-7b-butterfly-smoke",
            "train olmoe-1b-7b-butterfly-smoke"} <= \
        kernels[0]["launches_by_path"].keys()
    assert set(kernels[0]["zoo"]) == {"zoo"}
    assert set(kernels[1]["zoo"]) == set(ZOO_SMOKE["paged"]) | {
        f"{a} long" for a in ZOO_SMOKE["paged_long"]}
    assert "train_cli" in kernels[0]["launches_by_path"]
    for run in ("continuous", "resumed", "topk", "int8"):
        assert f"train cli {run}: [train] done: loss " in out
    assert "; exec [backend=torch]; resumed from step 2" in out
    assert "train cli resume: losses" in out
    assert "largest relative difference 0.000e+00" in out
    assert "train cli topk: losses" in out and "on the wire" in out
    assert ("train context seed 1: Trainer records torch and, built inside "
            "use_execution('torch'), torch") in out
    assert ("segments: butterfly backward small 5x64 float32: segment 3 "
            "named gives the unset field's bits; 1 and 6 refused") in out
    assert set(kernels[1]["launches_by_path"]) == {
        "serve", "router", "serve olmoe-1b-7b-butterfly-smoke",
        "serve gemma-7b-butterfly-smoke", "serve gemma3-27b-butterfly-smoke",
        "serve internvl2-1b-butterfly-smoke",
        "serve seamless-m4t-medium-butterfly-smoke"}
    assert kernels[3]["library_ms"] == 0.0 and kernels[4]["library_ms"] is None
    # sdpa's backward stands once, on dq, for the dq/dkv pair
    assert [k["library_ms"] for k in kernels[5:]] == [0.0, 0.0, None]
    assert {k["name"]: set(k["launches_by_path"]) for k in kernels[3:]} == {
        "butterfly_fwd": {"encdec", "sketch", "nonlinear"},
        "butterfly_bwd": {"encdec", "sketch", "nonlinear"},
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


@pytest.mark.parametrize("arch,sites,per_tick,train", [
    ("internvl2-1b-butterfly", ("up_gate", "down", "lm_head"), (73, 72),
     (2 * 145, 6 * 73)),
    ("seamless-m4t-medium-butterfly", ("up_gate", "down", "lm_head"),
     (25, 24), (2 * 73, 6 * 49)),
    ("recurrentgemma-2b-butterfly", ("up_gate", "down", "lm_head"),
     (79, 78), (2 * 157, 6 * 79)),
    ("xlstm-125m-butterfly", ("lm_head",), (1, 0), (2 * 1, 6 * 1)),
    ("olmoe-1b-7b-butterfly", ("lm_head",), (1, 0), (2 * 1, 6 * 1)),
    ("gemma3-27b-butterfly", ("up_gate", "down", "lm_head"), (187, 186),
     (2 * 373, 6 * 187))])
def test_site_and_launch_counts_of_the_full_width_archs(arch, sites,
                                                        per_tick, train):
    """The sandwich sites a forward pass of the full-width arch calls and
    the launch counts phases 24-34 hold: every layer with an MLP (the
    `rec`, `local` and `xdec` ones, not the MoE or xLSTM blocks) runs up,
    gate and down (up and down for GeLU); the head is one site; the
    encoder's 24 sites run once a step, outside remat."""
    smoke = _load_script()
    cfg = registry.get(arch)
    assert smoke.called_sites(cfg) == sites
    assert smoke.sandwich_sites(cfg) == per_tick
    assert smoke.train_counts(cfg) == train


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


def test_script_refuses_a_plain_route(tmp_path):
    """REPRO_KERNEL_BACKEND=torch would send every kernel of the run
    through the plain versions: the script refuses to start."""
    proc = subprocess.run([sys.executable, SCRIPT], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path,
                          env=dict(os.environ, REPRO_KERNEL_BACKEND="torch"))
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    assert "REPRO_KERNEL_BACKEND='torch'" in proc.stderr


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
