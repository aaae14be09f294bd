"""Rehearsal of `chip_smoke.py` on the CPU, phase 37, training on a
butterfly data mesh: two gloo ranks on the CPU in place of two on the
card, the smoke config's three sites at 64 and 63 rows and the butterfly
at 37 x 128 sharded against the plain versions alone, the smoke config
trained 2 steps at 16 x 4 unsharded and on the mesh, and the training
CLI's `--simulated-devices 2 --mesh-shape 2 --device cpu` as a
subprocess; and phase 38, sharded serving: the smoke config's 3 requests
(5 to 20 prompt tokens, 4 new) on 2 slots, unsharded and on two gloo
ranks, and the serving CLI's `--simulated-devices 2 --mesh-shape 2
--replicas 2 --device cpu` as a subprocess."""

from test_torch_chip_smoke import rehearse
from test_torch_chip_smoke import one_torch_thread  # noqa: F401


def test_rehearsal_mesh(capsys):
    _, kernels, out = rehearse(capsys, "mesh")
    assert "mesh world: rank 0 of 2 on cpu over gloo; took all_reduce" \
        in out
    assert "mesh world: rank 1 of 2 on cpu over gloo" in out
    assert "mesh nccl" not in out               # a card's world alone
    for what in ("sandwich up_gate 64->128 x 64",
                 "sandwich down 128->64 x 63",
                 "sandwich lm_head 64->512 x 64", "butterfly 37 x 128"):
        assert f"mesh site {what} on 2 ranks vs torch alone: forward" in out
    assert "mesh train smollm-135m-butterfly-smoke float32, 16 x 4, 2 " \
        "steps, unsharded vs 2 ranks: losses" in out
    assert "backend=torch mesh=data=2" in out
    assert "mesh train rank 1: step p50 " in out
    assert "peak not measured (no card)" in out
    assert "mesh cli: [train] smollm-135m-butterfly-smoke | 2 process(es)" \
        ", 2 device(s) (cpu, gloo)" in out
    assert "mesh cli: [train] done: loss" in out
    assert "mesh: phase " in out
    # the plain versions launch nothing; the paths are recorded
    assert kernels["sandwich_bwd"]["launches_by_path"] == {
        "mesh train rank 0": 0}
    assert kernels["butterfly_fwd"]["launches_by_path"] == {
        "mesh butterfly rank 0": 0}


def test_rehearsal_mesh_serve(capsys):
    _, kernels, out = rehearse(capsys, "mesh_serve")
    for rank in (0, 1):
        assert (f"mesh serve rank {rank} (rank {rank} of 2 on cpu over "
                f"gloo): 3 requests, ") in out
    assert "tokens equal to the unsharded engine's; decode tick p50" in out
    assert "launches a decode tick 0 sandwich, 0 paged, 7 gathers" in out
    assert "peak not measured (no card)" in out
    assert "mesh serve unsharded (eager):" in out
    assert "mesh serve cli: [serve] smollm-135m-butterfly-smoke" in out
    assert "| replicas=2 | mesh=data=2" in out
    assert "mesh serve cli: [serve] router: 3 requests over 2" in out
    assert "mesh serve: phase " in out
    # the plain versions launch nothing; the path is recorded
    assert kernels["sandwich_fwd (sandwich_factors + sandwich_rows)"][
        "launches_by_path"] == {"mesh serve rank 0": 0}


def test_rehearsal_ep_pipeline(capsys):
    """Phase 39 at smoke size on two gloo CPU ranks: the smoke OLMoE's MoE
    layer on a `(model 2)` mesh in float32 (32 tokens, two chunks of 16)
    and bfloat16 against one rank chunk by chunk, its butterfly LM at 2
    layers, and smollm's butterfly MLP block over 2 pipeline stages (the
    handover by point-to-point, which gloo takes on CPU tensors)."""
    _, kernels, out = rehearse(capsys, "ep_pipe")
    for rank in (0, 1):
        assert f"ep world: rank {rank} of 2 on cpu over gloo" in out
    assert ("ep layer olmoe-1b-7b-smoke float32 32 tokens (2 chunk(s) of "
            "16) on 2 model ranks vs one rank chunk by chunk") in out
    assert ("ep layer olmoe-1b-7b-smoke bfloat16 16 tokens (1 chunk(s) of "
            "16) on 2 model ranks") in out
    assert ("ep lm olmoe-1b-7b-butterfly-smoke 2 layers float32 2 x 16 on 2 "
            "model ranks vs one rank: loss") in out
    assert ("pipeline smollm-135m-butterfly-smoke MLP blocks, 2 stages, 8 x "
            "16, 4 microbatches on 2 stage ranks vs reference_apply") in out
    assert "handover p2p (gloo on cpu tensors): rank 0's shift 8 calls" in out
    assert "ep pipeline: phase " in out
    # the plain versions launch nothing; the paths are recorded
    assert kernels["sandwich_bwd"]["launches_by_path"] == {
        "ep lm rank 0": 0, "pipeline rank 0": 0}
