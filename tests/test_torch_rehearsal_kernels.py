"""Rehearsal of `chip_smoke.py` on the CPU, the kernels' group of phases:
the sandwich factor, forward and backward checks at smollm's full-width
sites and the widest output, the paged kernel at the serving, long and
zoo shapes, the wide-width sandwich backward checks at 100 -> 36 and at a
small zoo site, the butterfly kernels' checks, the sandwich backward at
the bench's width and the flash kernels at the training attention and
small shapes; the plain PyTorch versions stand in for the kernels."""

import torch

from test_torch_chip_smoke import one_torch_thread  # noqa: F401
from test_torch_chip_smoke import rehearse


def test_rehearsal_kernel_checks(capsys):
    _, kernels, out = rehearse(capsys, "kernels")
    assert kernels == {}                 # the timing phases fill them in
    for arch, kv, g, d in (("olmoe-1b-7b", 16, 1, 128),
                           ("dbrx-132b", 8, 6, 128),
                           ("mistral-large-123b", 8, 12, 128),
                           ("gemma-7b", 16, 1, 256),
                           ("internvl2-1b", 2, 7, 64),
                           ("seamless-m4t-medium", 16, 1, 64)):
        for dtype in ("float32", "bfloat16"):
            assert f"paged {arch} KV={kv} G={g} D={d} B=8 " \
                f"{(8, kv, g, d)} ps=16 P=32 {dtype}" in out
    for dtype in ("float32", "bfloat16"):
        assert f"paged gemma3-27b KV=16 G=2 D=128 B=8 (8, 16, 2, 128) " \
            f"ps=16 P=128 {dtype}" in out
    for rows in (8, 20):
        assert f"sandwich_bwd zoo 48->500 (n1 64, n2 512, k 6/9) " \
            f"rows={rows} bfloat16" in out
    assert "sandwich_bwd wide 100->36 (n1 128, n2 64, k 7/5) rows=64 " \
        "bfloat16" in out
    assert "sandwich factors vjp lm_head  max|err|" in out
    for site in ("up_gate", "down", "lm_head", "widest"):
        for dtype in ("float32", "bfloat16"):
            assert f"sandwich factors {site:8s} {dtype:9s} F_in" in out
    assert "sandwich factors widest   bfloat16  F_in (5, 32) F_out (18, " \
        "262144)" in out
    assert "butterfly ragged 37x128 Bt bfloat16" in out
    assert "flash wide B=1 H=1 S=9 D=192 float32 causal=True window=4" in out
    assert "flash train B=2 H=4 S=64 D=16 bfloat16 causal=True" in out
    assert torch.get_num_threads() == 1
