"""Rehearsal of `chip_smoke.py` on the CPU: every phase after the build
runs on the smoke-sized butterfly config with the plain PyTorch versions
in place of the kernels, so wrong paths, shapes and control flow show up
before the script reaches a card. Also the script's refusals: no result
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
                        time_fn=_call_once)
    out = capsys.readouterr().out
    assert "serve: 16 requests" in out
    assert [k["name"] for k in kernels] == ["sandwich_fwd",
                                            "paged_decode_attention"]
    for k in kernels:
        assert KEYS <= set(k)
        assert k["launches"] == 0          # plain versions launch nothing
        assert k["max_abs_err"] == 0.0     # plain vs plain
        assert k["bound_by"] == "bytes" and k["bound_ms"] > 0
        assert os.path.exists(os.path.join(ROOT, k["source"]))
    json.dumps({"kernels": kernels})


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
