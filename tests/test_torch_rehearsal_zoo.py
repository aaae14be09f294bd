"""Rehearsal of `chip_smoke.py` on the CPU, the zoo's group of phases
(24-35): the paged kernel and the sandwich timed at the zoo's shapes, the
OLMoE and Gemma butterfly smoke configs served, the MoE trained one step
and its greedy tokens, gemma3's rings served, trained and its tokens,
smollm's tokens on the dense pool, the recurrent archs' smoke configs
served on the dense pool, trained and their tokens with 1- and 2-token
prompts, and the frontend and encoder archs' smoke configs served with
their stub inputs, trained and their tokens on both pools; the plain
PyTorch versions stand in for the kernels."""

from repro_torch.configs import registry
from test_torch_chip_smoke import ZOO_SMOKE, rehearse
from test_torch_chip_smoke import one_torch_thread  # noqa: F401


def test_rehearsal_zoo(capsys):
    _, by_name, out = rehearse(capsys, "zoo")
    kernels = [by_name[n] for n in
               ("sandwich_fwd (sandwich_factors + sandwich_rows)",
                "paged_decode_attention", "sandwich_bwd")]
    # smollm's dense case, the MoE's three, gemma3's, the two recurrent
    # archs', the two frontend archs' two each
    assert out.count("give the same greedy tokens (64 tokens") == 11
    assert out.count("olmoe-1b-7b-butterfly-smoke float32, 4 prompts") == 3
    for arch in ZOO_SMOKE["paged"]:
        assert f"time paged {arch} B=8 P=32" in out
    assert "time sandwich zoo 48->500 rows=8 bfloat16: kernels" in out
    for arch in ZOO_SMOKE["serve"]:
        assert f"serve {arch}: init: " in out
        assert f"serve {arch}: 16 requests" in out
        assert f"serve {arch}: phase " in out
        assert f"profile {arch} graphed: device time not measured" in out
    assert "graph decode | olmoe-1b-7b-butterfly-smoke | 8 | " in out
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
    assert set(kernels[0]["zoo"]) == {"zoo"}
    assert set(kernels[1]["zoo"]) == set(ZOO_SMOKE["paged"]) | {
        f"{a} long" for a in ZOO_SMOKE["paged_long"]}
    trained = {f"train {a}" for a in (
        "olmoe-1b-7b-butterfly-smoke", "gemma3-27b-butterfly-smoke",
        "recurrentgemma-2b-butterfly-smoke", "xlstm-125m-butterfly-smoke",
        "internvl2-1b-butterfly-smoke",
        "seamless-m4t-medium-butterfly-smoke")}
    assert set(kernels[2]["launches_by_path"]) == trained
    assert set(kernels[1]["launches_by_path"]) == {
        "serve olmoe-1b-7b-butterfly-smoke",
        "serve gemma-7b-butterfly-smoke", "serve gemma3-27b-butterfly-smoke",
        "serve internvl2-1b-butterfly-smoke",
        "serve seamless-m4t-medium-butterfly-smoke"}
    assert {"serve olmoe-1b-7b-butterfly-smoke",
            "serve gemma-7b-butterfly-smoke"} | trained <= \
        kernels[0]["launches_by_path"].keys()
    assert all(k["launches"] == 0 for k in kernels)
