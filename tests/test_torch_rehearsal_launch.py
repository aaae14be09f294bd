"""Rehearsal of `chip_smoke.py` on the CPU, phase 36, the launch tooling:
the dry-run over two smoke archs and one shape (the card's run takes every
registry arch and shape) on one card and the two production pods, with
the one card's tables rendered and each cell's argument bytes a card and
fit on the pods, its parameter counts
held against a model built the way the serving phases build theirs, the
tile rule's record (empty: the plain versions query nothing), the
overrides honoured with the default's bits or refused before any work,
and the Trainer's record."""

import torch

from repro_torch.configs import registry
from test_torch_chip_smoke import _load_script, rehearse
from test_torch_chip_smoke import one_torch_thread  # noqa: F401


def test_rehearsal_launch_tools(capsys):
    smoke = _load_script()
    cfg = registry.get("xlstm-125m-butterfly-smoke")
    smoke.model_of(cfg, torch.device("cpu"))
    smoke.PEAKS.append(("serve", cfg, (64, 8), 0))
    _, kernels, out = rehearse(capsys, "launch", smoke=smoke)
    assert kernels == {}
    assert "dryrun | ## Roofline on one H100 (h100x1; NVIDIA H100 80GB " \
        "HBM3, 700.00 W)" in out
    for arch in ("smollm-135m-smoke", "xlstm-125m-smoke"):
        assert f"dryrun | | {arch} | decode_32k | " in out
        assert f"dryrun pods {arch} x decode_32k: pod16x16 " in out
    assert "GB a card, fit True; pod2x16x16 " in out
    assert ("dryrun: 6 tallied, 0 skipped, 0 failed over 2 archs x 1 shapes "
            "x 3 meshes (h100x1, pod16x16, pod2x16x16; collectives not "
            "modelled)") in out
    assert (f"dryrun params xlstm-125m-butterfly-smoke ({cfg.n_layers} "
            f"layers): param_counts") in out
    assert "dryrun args serve xlstm-125m-butterfly-smoke 64 x 8: " in out
    assert "not measured (no card)" in out
    assert ("tuning: 0 choices, every one of the 0 launched cells named; "
            "modeled shared memory within the opt-in 232448 B: no kernel "
            "tuning queried (plain versions)") in out
    assert ("tuning overrides: butterfly 300x1024 float32 forward block_b=16"
            " and backward block_b=2 (plan tile None) give the default's "
            "bits; refused before any launch: block_b=3: the butterfly bwd "
            "kernel at n=1024 float32 takes block_b multiples of 2 up to 8; "
            "block_b=32: the butterfly fwd kernel at n=1024 float32 takes "
            "block_b 16; block_b=32: the sandwich fwd kernel") in out
    assert "tuning record: Trainer on cpu: ''" in out
    assert "launch tools: phase " in out
