"""Rehearsal of `chip_smoke.py` on the CPU: every phase after the build
(serving, the sandwich backward check, training and its gradient check,
the butterfly kernels' checks and the encoder-decoder at 64 x 256) runs on
the smoke-sized butterfly config with the plain PyTorch versions in place
of the kernels, so wrong paths, shapes and control flow show up before the
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
    kernels = smoke.run(torch, np, cfg, torch.device("cpu"), kernel="torch",
                        time_fn=_call_once, train_shape=(64, 2),
                        encdec_shape=(64, 256, 4), encdec_steps=(3, 2),
                        bfly_shapes=(("small", 5, 64), ("ragged", 37, 128)))
    out = capsys.readouterr().out
    assert "serve: 16 requests" in out
    assert "train: losses" in out
    assert (f"cotangents: {3 * (3 * cfg.n_layers + 1)} butterfly leaves"
            in out)
    assert "butterfly ragged 37x128 Bt bfloat16" in out
    assert "encdec two_phase/k4: thm1_prediction=" in out
    assert "encdec kernels vs plain: gradient" in out
    assert [k["name"] for k in kernels] == ["sandwich_fwd",
                                            "paged_decode_attention",
                                            "sandwich_bwd", "butterfly_fwd",
                                            "butterfly_bwd"]
    assert kernels[3]["library_ms"] == 0.0 and kernels[4]["library_ms"] is None
    assert {k["name"]: set(k["launches_by_path"]) for k in kernels[3:]} == {
        "butterfly_fwd": {"encdec"}, "butterfly_bwd": {"encdec"}}
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
