"""`repro_torch.launch.paper` and `repro_torch.examples` on the CPU.

The launcher prints every row of the reference's parameter-count,
gated-butterfly, sketch and butterfly-LM benches under the reference's
names and `derived` keys (`BENCH_quick.json`, and `bench_sketch.py`'s ℓ
sweep, which the quick run skips). The `params/*` rows' dense and sandwich
counts and the LM parameter counts are deterministic and equal the
reference's printed numbers exactly; the trained rows' values depend on
draws and steps and are held finite only. Each example's `main` runs at
its smallest setting."""

import functools
import json
import math
import os

import pytest
import torch

from repro_torch.launch import paper
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SECTION_PREFIXES = ("params/", "nonlinear/", "sketch/", "lm_butterfly/")


def _derived(row):
    return dict(kv.split("=", 1) for kv in row["derived"].split(";"))


@functools.lru_cache(maxsize=None)
def _reference_rows():
    with open(os.path.join(ROOT, "BENCH_quick.json")) as f:
        rows = json.load(f)["rows"]
    return {r["name"]: r for r in rows if r["name"].startswith(
        SECTION_PREFIXES)}


@functools.lru_cache(maxsize=None)
def _rows():
    steps = {key: 2 for key in paper.FULL_STEPS}
    return {r["name"]: r for r in paper.run(torch.device("cpu"),
                                            steps=steps)}


def test_every_reference_row_with_its_derived_keys():
    got, want = _rows(), _reference_rows()
    sweep = {f"sketch_ell/l{ell}_k8" for ell in paper.SKETCH_ELLS}
    assert set(got) == set(want) | sweep
    for name, row in want.items():
        assert list(_derived(got[name])) == list(_derived(row)), name
    for name in sweep:
        assert list(_derived(got[name])) == ["butterfly_learned",
                                             "sparse_learned"]
    for name, row in got.items():
        if not name.startswith("params/"):
            for key, value in _derived(row).items():
                # 64 columns into 32 rows leave sparse sketch rows empty:
                # the learned values turn NaN, in the reference too
                # (test_torch_sketch.py, the ℓ = 32 case)
                if (name, key) != ("sketch_ell/l32_k8", "sparse_learned"):
                    assert math.isfinite(float(value)), (name, key)


def test_param_and_lm_counts_equal_the_reference():
    got, want = _rows(), _reference_rows()
    for name, row in want.items():
        if name.startswith("params/"):
            for key in ("dense", "butterfly"):
                assert _derived(got[name])[key] == _derived(row)[key], name
    lm = _derived(got["lm_butterfly/final_loss"])
    ref = _derived(want["lm_butterfly/final_loss"])
    assert (lm["dense_params"], lm["butterfly_params"]) == (
        ref["dense_params"], ref["butterfly_params"]) == ("139584", "83314")


def test_main_prints_csv_and_writes_json(tmp_path, capsys):
    out = tmp_path / "rows.json"
    assert paper.main(["--device", "cpu", "--only", "params", "--only",
                       "sketch_ell", "--steps", "1", "--n", "32", "--d",
                       "24", "--ell", "8", "--k", "4",
                       "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert lines[1].startswith("params/efficientnet-b0,0.00,dense=12810;")
    assert lines[-1].startswith("sketch_ell/l8_k4,0.00,butterfly_learned=")
    doc = json.loads(out.read_text())
    assert doc["device"] == "cpu" and len(doc["rows"]) == len(lines) - 1


def test_quick_steps_and_the_card_default(monkeypatch):
    assert paper.QUICK_STEPS == {"nonlinear": 120, "sketch": 30,
                                 "sketch_ell": 30, "lm_butterfly": 15}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper.main(["--only", "params"])


EXAMPLES = {
    "quickstart": (["--n", "64", "--k", "8", "--rows", "32", "--steps", "4"],
                   ["butterfly params: 1,600", "loss after 4 steps",
                    "matches the default route: True"]),
    "learned_sketch": (["--n", "32", "--d", "24", "--ell", "8", "--k", "4",
                        "--steps", "3"],
                       ["butterfly learned :", "Gaussian          :"]),
    "butterfly_autoencoder": (["--n", "64", "--steps1", "3", "--steps2",
                               "2"],
                              ["Theorem 1 prediction", "final loss"]),
    "train_lm": (["--steps", "2", "--seq-len", "16", "--global-batch", "2",
                  "--microbatches", "1", "--butterfly"],
                 ["training smollm-135m-butterfly-smoke: 2 steps",
                  "final loss:"]),
    "serve_lm": (["--requests", "2", "--gen-len", "4", "--max-len", "32"],
                 ["req[99] cancelled", "swapped replica 0 to checkpoint "
                  "step 1 (newest was torn)"]),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_cpu(name, tmp_path, capsys):
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    argv, wants = EXAMPLES[name]
    if name == "train_lm":
        argv = argv + ["--checkpoint-dir", str(tmp_path)]
    assert mod.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for want in wants:
        assert want in out, (want, out)


def test_serve_lm_refuses_archs_the_port_lacks(capsys):
    """The serving demo's three acts on the vision frontend's smoke arch,
    its requests carrying stub embeddings: whole prompts (no chunks) and
    eager admission on the tiny pool; an unknown name exits."""
    from repro_torch.examples import serve_lm
    assert serve_lm.main(["--arch", "internvl2-1b-smoke", "--device", "cpu",
                          "--requests", "3", "--gen-len", "4"]) == 0
    out = capsys.readouterr().out
    for want in ("whole-prompt prefill runs eagerly",
                 "lifecycle demo: tiny pool, eager admission",
                 "swapped replica 0 to checkpoint step 1"):
        assert want in out, (want, out)
    with pytest.raises(SystemExit, match="unknown architecture"):
        serve_lm.main(["--arch", "internvl2-1b-tiny", "--device", "cpu"])
