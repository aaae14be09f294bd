"""Rehearsal of `chip_smoke.py` on the CPU, the training group of phases:
training and its gradient checks (layer by layer, a whole float32 step),
the training CLI's continuous, resumed and compressed runs with the
execution context's checks, and the sandwich backward's timing; the plain
PyTorch versions stand in for the kernels."""

from repro_torch.configs import registry
from test_torch_chip_smoke import check_entries, rehearse
from test_torch_chip_smoke import one_torch_thread  # noqa: F401


def test_rehearsal_training(capsys):
    _, kernels, out = rehearse(capsys, "train")
    cfg = registry.get("smollm-135m-butterfly-smoke")
    assert "train: losses" in out
    assert (f"cotangents: {3 * (3 * cfg.n_layers + 1)} butterfly leaves"
            in out)
    assert "dense backward" in out
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
    assert out.count("train step float32, whole step through all 2 layers") \
        == 1
    fwd, bwd = (kernels["sandwich_fwd (sandwich_factors + sandwich_rows)"],
                kernels["sandwich_bwd"])
    assert set(fwd["launches_by_path"]) == {"train", "train_cli"}
    assert set(bwd["launches_by_path"]) == {"train", "train_cli"}
    check_entries(kernels, ["sandwich_bwd"])
