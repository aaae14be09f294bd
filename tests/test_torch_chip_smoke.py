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
with their stub inputs, trained and their tokens on both pools, and the
mesh phase's ranks on the CPU) runs on the smoke-sized butterfly config
with the plain
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


# the rehearsal's sizes: run()'s keyword arguments at smoke size
REHEARSAL = dict(
    kernel="torch", train_shape=(64, 2), encdec_shape=(64, 256, 4),
    encdec_steps=(3, 2), bfly_shapes=(("small", 5, 64), ("ragged", 37, 128)),
    flash_shapes=(("window", 1, 2, 33, 8, ("float32",), False, 24),
                  ("wide", 1, 1, 9, 192, ("float32",), True, 4)),
    flash_timed=("window",), bench=dict(ns=(64,), batch=4, iters=1),
    wide=("wide", 100, 36),
    cli=dict(replicas=2, slots=2, max_len=64, requests=4, min_prompt=5,
             max_prompt=20, max_new=4, rate=50.0),
    layers=(("up", 64, 96, None, None, 8, True),
            ("quick", 64, 64, 8, 8, 8, False)),
    fit=(64, 8, 32, 5), sketch_run=(64, 48, 16, 8, 24, 8, 20),
    gated=((16, 64),), nonlinear_steps=2, lm_steps=2, zoo=ZOO_SMOKE,
    launch=dict(archs=("smollm-135m-smoke", "xlstm-125m-smoke"),
                shapes=("decode_32k",), limit_s=None),
    mesh=dict(ranks=2, rows=(64, 63), butterfly=(37, 128),
              train=(16, 4, 2), cli=("smollm-135m-butterfly-smoke", 1, 16,
                                     3), budget_s=None),
    mesh_serve=dict(ranks=2, engine=(2, 64, 16), requests=(3, 5, 20, 4),
                    cli=("smollm-135m-butterfly-smoke", 3), budget_s=None),
    ep_pipe=dict(ranks=2,
                 layer=("olmoe-1b-7b-smoke", 16, (("float32", 2, 16),
                                                  ("bfloat16", 2, 8))),
                 lm=("olmoe-1b-7b-butterfly-smoke", 2, 16, 2),
                 pipeline=("smollm-135m-butterfly-smoke", 2, 8, 16, 4),
                 budget_s=None))


def rehearse(capsys, *groups, smoke=None):
    """``chip_smoke.run`` on the CPU at the rehearsal's sizes, the plain
    versions in place of the kernels, for ``groups`` of its phases (each
    group's test file runs on its own worker); returns (the script's
    module, its kernels line's entries by name, what it printed)."""
    smoke = smoke or _load_script()
    cfg = registry.get("smollm-135m-butterfly-smoke")
    kernels = smoke.run(torch, np, cfg, torch.device("cpu"),
                        time_fn=_call_once, groups=groups, **REHEARSAL)
    return smoke, {k["name"]: k for k in kernels}, capsys.readouterr().out


def check_entries(kernels, names) -> None:
    """The kernels line's entries ``names`` as the card prints them, with
    the plain versions' zero launches and errors."""
    for name in names:
        k = kernels[name]
        assert KEYS <= set(k)
        assert k["launches"] == 0          # plain versions launch nothing
        assert k["max_abs_err"] == 0.0     # plain vs plain
        assert k["bound_by"] in ("bytes", "operations")
        assert k["bound_ms"] > 0
        assert os.path.exists(os.path.join(ROOT, k["source"]))
    json.dumps({"kernels": list(kernels.values())})


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
