"""Rehearsal of `chip_smoke.py` on the CPU, the encoder-decoder and bench
group of phases: the encoder-decoder at 64 x 256 against the plain
versions, the butterfly kernels' timing, the benches at n = 64, the flash
kernels through autograd and their timing; and the paper's group: the
layer API at 64 -> 96 and 64 x 64, the learned sketch at 64 x 48 and the
paper's rows at 2 steps. The plain PyTorch versions stand in for the
kernels."""

from test_torch_chip_smoke import check_entries, rehearse
from test_torch_chip_smoke import one_torch_thread  # noqa: F401


def test_rehearsal_encdec_and_benches(capsys):
    _, kernels, out = rehearse(capsys, "encdec")
    assert "encdec two_phase/k4: thm1_prediction=" in out
    assert "encdec kernels vs plain: gradient" in out
    assert "FlashFn train bfloat16 through autograd" in out
    assert ("bench: backward/flash_fwdbwd_fused_n64,,status=skipped;"
            "reason=no_cuda" in out)
    assert "time flash_bwd_dkv window B=1 H=2 S=33 D=8 float32" in out
    for row in ("kernel/butterfly_n64", "speed/train_n64",
                "backward/sandwich_fwdbwd_fused_n64",
                "backward/flash_fwdbwd_fused_n64"):
        assert f"bench {row} kernels vs plain, float32" in out
    assert "time attention train B=2 S=64 4 heads (2 KV)" in out
    names = ["butterfly_fwd", "butterfly_bwd", "flash_fwd", "flash_bwd_dq",
             "flash_bwd_dkv"]
    assert list(kernels) == names
    assert kernels["butterfly_fwd"]["library_ms"] == 0.0
    assert kernels["butterfly_bwd"]["library_ms"] is None
    # sdpa's backward stands once, on dq, for the dq/dkv pair
    assert [kernels[n]["library_ms"] for n in names[2:]] == [0.0, 0.0, None]
    assert {n: set(kernels[n]["launches_by_path"]) for n in names} == {
        "butterfly_fwd": {"encdec"}, "butterfly_bwd": {"encdec"},
        "flash_fwd": {"bench"}, "flash_bwd_dq": {"bench"},
        "flash_bwd_dkv": {"bench"}}
    assert [kernels[n]["replaces"] for n in names[2:]] == [
        f"src/repro/kernels/flash.py:{n}" for n in (69, 101, 130)]
    check_entries(kernels, names)


def test_rehearsal_paper_layers(capsys):
    _, kernels, out = rehearse(capsys, "paper")
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
        == 1
    for row in ("nonlinear/linear_target", "nonlinear/mlp_target",
                "lm_butterfly/final_loss"):
        assert f"paper: {row},0.00," in out
    assert "dense_params=139584;butterfly_params=83314" in out
    for what in ("layer api quickstart fit", "sketch: phase", "paper rows: "
                 "phase"):
        assert what in out
    # each path's launches join its kernels' entries (stubs here: their
    # timing phases are the other groups')
    assert {n: set(k["launches_by_path"]) for n, k in kernels.items()} == {
        "sandwich_fwd (sandwich_factors + sandwich_rows)":
            {"layer_api", "lm_butterfly"},
        "sandwich_bwd": {"layer_api", "lm_butterfly"},
        "butterfly_fwd": {"sketch", "nonlinear"},
        "butterfly_bwd": {"sketch", "nonlinear"}}
    assert all(k["launches"] == 0 for k in kernels.values())
