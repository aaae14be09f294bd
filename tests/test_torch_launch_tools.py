"""The port's launch tooling (`repro_torch.launch.{roofline,op_analysis,
specs,dryrun,report}`) against the reference's (`repro.launch.*`), on the
CPU at smoke size.

Module 1's work counts reproduce the bounds PERF.md's kernel table prints
(the digits printed; NVIDIA H100 80GB HBM3, 700 W constants), and its
report carries the reference's keys. The specs' ``param_counts`` and
``model_flops``, the dry-run's ``choose_microbatches`` and
``cell_applicable`` equal the reference's over every registry arch ×
shape (all analytic, no compile). The op tally counts smollm-135m-smoke's
matmul FLOPs exactly as an analytic count of its projections and attention
products, a loop counted once and multiplied as unrolled, and a dry-run
cell on meta writes its JSON, which the report renders. The package
imports neither jax nor the reference (grepped).
"""

import json
import math
import os
import re

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, cell_applicable
from repro_torch.core.layers import ButterflySpec
from repro_torch.launch import dryrun, report
from repro_torch.launch import roofline as rl
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs
from repro_torch.launch.op_analysis import OpTally
from repro_torch.models import common as cm
from repro_torch.models import lm
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src",
                   "repro_torch")


def _reference_dryrun():
    """``repro.launch.dryrun``, imported with this process's XLA_FLAGS
    kept: its first line sets them for a 512-device process of its own."""
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return jdryrun


# ---------------------------------------------------------------------------
# Module 1: the card's roofline and the kernels' work counts
# ---------------------------------------------------------------------------

def _site_specs(name):
    cfg = registry.get(name)
    bc = cfg.butterfly
    E, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    sites = {"up_gate": ("mlp_up", E, F), "down": ("mlp_down", F, E),
             "lm_head": ("lm_head", E, V)}
    mix = {"up_gate": 2 * cfg.n_layers, "down": cfg.n_layers, "lm_head": 1}
    return [(cm.site_butterfly_spec(bc.seed, key, n_in, n_out, bc.k_factor,
                                    bc.use_bias), mix[site])
            for site, (key, n_in, n_out) in sites.items()]


def _mix_bound(work, rows):
    return sum(count * rl.bound_ms(*work(spec, rows, "bfloat16"),
                                   rl.PEAK_FP32)[0]
               for spec, count in _site_specs("smollm-135m-butterfly"))


def test_work_counts_reproduce_the_kernel_tables_bounds():
    """PERF.md §6's bounds from the work functions: the sandwich over a
    smollm decode tick's site mix at 8 rows and a train step's at 8192,
    its backward at 8192, the paged kernel at the serving and the long
    shape, the butterfly pair at 70,000 × 1024, and the flash triple at
    the bench's S = 8192 (float32, at the 3xTF32 rate) and the training
    attention (bfloat16)."""
    assert f"{_mix_bound(rl.sandwich_fwd_work, 8):.4f}" == "0.0107"
    assert f"{_mix_bound(rl.sandwich_fwd_work, 8192):.3f}" == "1.182"
    assert f"{_mix_bound(rl.sandwich_bwd_work, 8192):.3f}" == "1.589"
    cfg = registry.get("smollm-135m-butterfly")
    KV, D = cfg.n_kv_heads, cfg.head_dim_
    G = cfg.n_heads // KV
    for cur, pages, want in (((0, 15, 16, 100, 255, 300, 511, 47), 32,
                              "0.00029"),
                             ((2047, 2000, 1500, 1024, 777, 511, 16, 0), 128,
                              "0.00181")):
        live = sum(c + 1 for c in cur)
        work = rl.paged_decode_work(8, KV, G, D, live, pages, "bfloat16")
        assert f"{rl.bound_ms(*work, rl.PEAK_BF16)[0]:.5f}" == want
    for work in (rl.butterfly_fwd_work(70000, 1024, "float32"),
                 rl.butterfly_bwd_work(70000, 1024, "float32")):
        ms, by = rl.bound_ms(*work, rl.PEAK_FP32)
        assert (f"{ms:.4f}", by) == ("0.1712", "bytes")
    for fn, f32, bf16 in ((rl.flash_fwd_work, "0.1041", "0.0196"),
                          (rl.flash_dq_work, "0.1562", "0.0293"),
                          (rl.flash_dkv_work, "0.2083", "0.0391")):
        assert f"{rl.bound_ms(*fn(1, 2, 8192, 64, 'float32'), rl.PEAK_3XTF32)[0]:.4f}" == f32
        assert f"{rl.bound_ms(*fn(4, 9, 2048, 64, 'bfloat16'), rl.PEAK_BF16)[0]:.4f}" == bf16


@pytest.mark.parametrize("case", ["dense", "by_hand"])
def test_sandwich_op_counts(case):
    """The bounds' operation counts: on a dense support they are the dense
    formula (3 ops per element and stage forward; backward 3 recompute, 3
    dual, 4 for the two weight products, less the output chain's last
    recompute; the core 2·k1·k2 forward and 4·k1·k2 backward, and the
    scales), and a 2-wide sandwich with one selected and one scattered
    value is counted by hand."""
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
    assert rl.sandwich_ops(spec) == want


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0), (False, 5)])
def test_flash_bound_counts_the_visible_pairs(causal, window):
    """The flash bounds count the entries the mask keeps, and per kernel
    4·D, 6·D and 8·D operations per entry."""
    from repro_torch.kernels import flash as kf
    S = 13
    pairs = int(kf.visible_mask(S, causal, window).sum())
    assert rl.flash_pairs(S, causal, window) == pairs
    arr, rows = 2 * 3 * S * 8 * 2, 2 * 3 * S * 4
    args = (2, 3, S, 8, "bfloat16", causal, window)
    assert rl.flash_fwd_work(*args) == (4 * arr + rows, 4 * 8 * 6 * pairs)
    assert rl.flash_dq_work(*args) == (5 * arr + 2 * rows, 6 * 8 * 6 * pairs)
    assert rl.flash_dkv_work(*args) == (6 * arr + 2 * rows,
                                        8 * 8 * 6 * pairs)


def test_report_terms_and_keys_follow_the_reference():
    """One card: no collective term; the fit against 80 GB; the
    reference's dictionary keys."""
    from repro.launch.roofline import CollectiveStats as JStats
    from repro.launch.roofline import RooflineReport as JReport
    r = rl.RooflineReport("a", "s", "h100x1", 1, flops_per_device=989e12,
                          bytes_per_device=3.35e12 / 2, argument_bytes=81e9,
                          model_flops=494.5e12)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 0.5, 0.0)
    assert r.dominant == "compute" and r.bound_time == 1.0
    assert r.roofline_fraction == r.flops_utilization == 0.5
    assert not r.hbm_fit
    j = JReport("a", "s", "m", 1, 1.0, 1.0, JStats())
    assert set(r.to_dict()) == set(j.to_dict())
    assert rl.smem_optin_bytes() == 227 * 1024 == rl.SMEM_OPTIN_BYTES


# ---------------------------------------------------------------------------
# Specs and the dry-run's rules against the reference's
# ---------------------------------------------------------------------------

def test_param_counts_and_model_flops_equal_the_reference():
    """Every registry arch × shape: the port's parameter counts (its meta
    model's) and model FLOPs equal ``repro.launch.specs``'."""
    from repro.configs import registry as jreg
    from repro.configs.base import SHAPES as JSHAPES
    from repro.launch import specs as jspecs
    assert registry.names() == jreg.names()
    for arch in registry.names():
        cfg, jcfg = registry.get(arch), jreg.get(arch)
        assert specs.param_counts(cfg) == jspecs.param_counts(jcfg), arch
        for shape, jshape in zip(SHAPES, JSHAPES):
            assert specs.model_flops(cfg, shape) == \
                jspecs.model_flops(jcfg, jshape, 1), (arch, shape.name)


def test_microbatches_and_applicable_cells_equal_the_reference():
    from repro.configs import registry as jreg
    from repro.configs.base import SHAPES as JSHAPES
    from repro.configs.base import cell_applicable as jcell
    jdryrun = _reference_dryrun()
    for arch in registry.names():
        for shape, jshape in zip(SHAPES, JSHAPES):
            cfg, jcfg = registry.get(arch), jreg.get(arch)
            assert cell_applicable(cfg, shape) == jcell(jcfg, jshape)
            for n_dp in (1, 4, 16):
                assert dryrun.choose_microbatches(cfg, shape, n_dp) == \
                    jdryrun.choose_microbatches(jcfg, jshape, n_dp)


def test_batch_and_decode_specs_are_meta():
    cfg = registry.get("internvl2-1b-smoke")
    shape = SHAPES[0]
    batch = specs.batch_specs(cfg, shape)
    assert set(batch) == {"tokens", "targets", "mask", "frontend_embeds"}
    assert all(t.device.type == "meta" for t in batch.values())
    token, caches, cur = specs.decode_specs(cfg, SHAPES[2])
    assert token.shape == (SHAPES[2].global_batch,) and cur.shape == ()
    # the prefix counts in a vision request's cache length
    assert caches["k"].shape[2] == SHAPES[2].seq_len + cfg.frontend_tokens


# ---------------------------------------------------------------------------
# Module 2: the op tally
# ---------------------------------------------------------------------------

def _loss_batch(cfg, B, S):
    with torch.device("meta"):
        return {"tokens": torch.zeros(B, S, dtype=torch.int32),
                "targets": torch.zeros(B, S, dtype=torch.int32),
                "mask": torch.ones(B, S)}


def test_tally_counts_smollm_smoke_matmuls_exactly():
    """The forward's matmul FLOPs are its projections (q, k, v, o, gate,
    up, down a layer; the head) and attention's two products over the
    whole S × S (the masked path computes them all), 2 FLOPs a
    multiply-add; the total besides is set beside the reference's HLO
    count of its jitted forward at the same shape (XLA fuses elementwise
    work and counts what it keeps, so the ratio is reported, not
    bounded)."""
    import jax

    from repro.configs import registry as jreg
    from repro.launch import hlo_analysis
    from repro.launch import specs as jspecs
    from repro.models import lm as jlm
    cfg = registry.get("smollm-135m-smoke")
    B, S = 2, 32                    # below blockwise_threshold: masked path
    E, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    per_layer = (E * H * D + 2 * E * KV * D + H * D * E + 3 * E * F
                 + 2 * H * S * D)
    want = 2 * B * S * (cfg.n_layers * per_layer + E * V)
    model = specs.abstract_model(cfg)
    with torch.no_grad(), OpTally() as tally:
        lm.loss_fn(model, _loss_batch(cfg, B, S))
    assert tally.matmul_flops == want
    jcfg = jreg.get("smollm-135m-smoke")
    sds = jax.ShapeDtypeStruct
    batch = {"tokens": sds((B, S), "int32"), "targets": sds((B, S), "int32"),
             "mask": sds((B, S), "float32")}
    text = jax.jit(lambda p, b: jlm.loss_fn(jcfg, p, b)[0]).lower(
        jspecs.abstract_model(jcfg), batch).compile().as_text()
    ratio = tally.flops / hlo_analysis.analyze(text).flops
    print(f"op tally / reference HLO FLOPs, smollm-135m-smoke forward "
          f"{B}x{S}: {ratio:.4f}")
    assert math.isfinite(ratio) and ratio > 0


def _tallies(cfg, B, S, train):
    model = specs.abstract_model(cfg)
    params = list(model.parameters())
    out = []
    for loops in (True, False):
        tally = OpTally(loops=loops)
        with torch.set_grad_enabled(train), tally:
            with tally.repeat(3):          # a microbatch loop of 3
                loss, _ = lm.loss_fn(model, _loss_batch(cfg, B, S))
            if train:
                torch.autograd.grad(loss, params, allow_unused=True)
        out.append(tally)
    return out


@pytest.mark.parametrize("name,B,S,train", [
    ("smollm-135m-butterfly-smoke", 2, 32, True),
    ("gemma3-27b-smoke", 2, 40, True),
    ("xlstm-125m-smoke", 2, 64, False)])
def test_multiplied_tally_equals_the_unrolled_one(name, B, S, train):
    """Counting one repeat of the layer unit (and one step of the xLSTM's
    loops over time, the blockwise attention's loop over key blocks)
    and multiplying gives the unrolled tally's FLOPs and bytes, kind by
    kind, forward and backward (remat's recompute and the plain sandwich
    twin's own autograd included); only the op count of ``stack`` differs
    (one stack of two steps stands for one of all of them)."""
    multiplied, unrolled = _tallies(registry.get(name), B, S, train)
    assert multiplied.flops == unrolled.flops
    assert multiplied.matmul_flops == unrolled.matmul_flops
    assert multiplied.bytes == unrolled.bytes
    assert multiplied.flops_by_kind == unrolled.flops_by_kind
    assert multiplied.bytes_by_kind == unrolled.bytes_by_kind
    for kind in set(multiplied.counts) | set(unrolled.counts):
        if kind != "stack":
            assert multiplied.counts[kind] == unrolled.counts[kind], kind


# ---------------------------------------------------------------------------
# The dry-run and its report
# ---------------------------------------------------------------------------

def test_dryrun_cell_writes_its_json_and_the_report_renders_it(tmp_path,
                                                                capsys):
    """Cells of two smoke archs on meta: a training step (microbatched,
    xLSTM's loops counted once), a decode step and a skipped cell, each
    written as ``<arch>__<shape>__h100x1.json`` and rendered by the
    report."""
    cells = (("xlstm-125m-smoke", ("train_4k",)),
             ("smollm-135m-smoke", ("decode_32k", "long_500k")))
    for arch, shapes in cells:
        assert dryrun.run([arch], list(shapes), str(tmp_path))[
            "failures"] == 0
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"{a}__{s}__h100x1.json" for a, shapes in cells for s in shapes)
    with open(tmp_path / "xlstm-125m-smoke__train_4k__h100x1.json") as f:
        r = json.load(f)
    cfg = registry.get("xlstm-125m-smoke")
    assert r["status"] == "ok" and r["n_devices"] == 1
    assert r["microbatches"] == dryrun.choose_microbatches(cfg, SHAPES[0])
    assert r["params_total"] == specs.param_counts(cfg)[0]
    assert r["argument_parts"]["adam_moments"] == 8 * r["params_total"] + 4
    assert r["hbm_fit"] and "argument bytes" in r["fit_basis"]
    assert r["flops_per_device"] > r["model_flops"] > 0
    with open(tmp_path / "smollm-135m-smoke__decode_32k__h100x1.json") as f:
        r = json.load(f)
    assert r["status"] == "ok" and r["tokens"] == SHAPES[2].global_batch
    with open(tmp_path / "smollm-135m-smoke__long_500k__h100x1.json") as f:
        assert json.load(f)["status"] == "skipped"
    capsys.readouterr()
    report.main([str(tmp_path)])
    text = capsys.readouterr().out
    assert "| xlstm-125m-smoke | train_4k |" in text
    assert "| smollm-135m-smoke | long_500k |" in text
    assert rl.CARD in text
    rows = [ln for ln in text.splitlines() if ln.startswith("| smollm")]
    assert len(rows) == 4                     # two cells, in both tables


@pytest.mark.parametrize("choice,mesh,n", [("single", "pod16x16", 256),
                                            ("multi", "pod2x16x16", 512)])
def test_dryrun_on_a_production_mesh(tmp_path, capsys, choice, mesh, n):
    """``--mesh single|multi``: the reference's pods laid out without
    ranks. A training cell and a decode cell of the xLSTM smoke arch each
    write ``<arch>__<shape>__<mesh>.json``: argument bytes a card from the
    sharding trees (the parts summed, each under the one-card bytes and
    the parameters' equal to ``specs.tree_bytes`` of
    ``param_shardings``), the one-card tally spread over ``n`` devices
    (shared with the one-card cell, not made again) and spread by the
    trees (each group of its bytes as its tensors shard), ``model_flops``
    over ``n``, the reference's microbatches over the pod's data axes,
    what the port executes, and collectives said to be not modelled."""
    arch = "xlstm-125m-smoke"
    cfg = registry.get(arch)
    dryrun.main(["--arch", arch, "--shape", "train_4k,decode_32k",
                 "--out", str(tmp_path), "--mesh", "h100x1"])
    tallied = dict(dryrun._TALLIES)
    dryrun.main(["--arch", arch, "--shape", "train_4k,decode_32k",
                 "--out", str(tmp_path), "--mesh", choice])
    assert dryrun._TALLIES == tallied
    assert f"0 failed" in capsys.readouterr().out
    layout = tmesh.production_layout(multi_pod=choice == "multi")
    n_dp = layout.size // layout.shape["model"]
    for shape in (SHAPES[0], SHAPES[2]):
        with open(tmp_path / f"{arch}__{shape.name}__h100x1.json") as f:
            one = json.load(f)
        with open(tmp_path / f"{arch}__{shape.name}__{mesh}.json") as f:
            r = json.load(f)
        assert r["status"] == "ok" and r["n_devices"] == n
        assert r["mesh_shape"] == layout.shape
        parts = r["argument_parts"]
        assert parts["total"] == sum(v for k, v in parts.items()
                                     if k != "total") == r["argument_bytes"]
        for k, v in parts.items():
            assert 0 < v <= one["argument_parts"][k], k
        named = dict(specs.abstract_model(cfg).named_parameters())
        assert parts["params"] == specs.tree_bytes(
            named, specs.param_shardings(cfg, layout), layout)
        # the batch splits over pod x data here, so the FLOPs over all
        assert r["flops_per_device"] == pytest.approx(
            one["flops_per_device"] / n, rel=1e-12)
        group = one["tally"]["bytes_by_group"]
        rest = one["bytes_per_device"] - sum(group.values())
        gathered = {k: tuple(None if e in (None, "data", "pod")
                             or "data" in e else e for e in v)
                    for k, v in specs.param_shardings(cfg, layout).items()}
        read = specs.tree_bytes(named, gathered, layout)
        whole = specs.tensor_bytes(named)
        passes = r.get("microbatches", 1) / one.get("microbatches", 1)
        want = (group.get("weights", 0) * passes * read / whole
                + group.get("state", 0) * parts["params"] / whole
                + group.get("caches", 0) * parts.get("caches", 0)
                / one["argument_parts"].get("caches", 1)
                + rest / n_dp)
        assert r["bytes_per_device"] == pytest.approx(want, rel=1e-12)
        assert r["model_flops"] == specs.model_flops(cfg, shape, n)[0]
        assert r["hbm_fit"] and "not modelled" in r["collectives"]
        assert r["executes"]["accounting_only"] == ["model"]
        assert r["executes"]["experts"] == []
        assert r["executes"]["sharded"] == [a for a in ("pod", "data")
                                            if a in layout.shape]
        if shape.kind == "train":
            assert r["microbatches"] == dryrun.choose_microbatches(
                cfg, shape, n_dp)
    report.main([str(tmp_path)])
    assert f"({mesh};" in capsys.readouterr().out


@pytest.mark.parametrize("arch,ep", [
    ("olmoe-1b-7b", True), ("dbrx-132b", True), ("smollm-135m", False),
    ("olmoe-1b-7b-smoke", False)])
def test_dryrun_executes_experts_over_model(arch, ep):
    """On ``pod16x16`` the ``executes`` record names ``model`` as running
    the experts where the MoE's expert count is a multiple of its 16 (64
    and 16 experts; the smoke arch's 8 is not), as the reference's
    ``moe_apply`` decides; ``model`` stays accounting only for every other
    tensor, and a dense arch runs nothing over it."""
    layout = tmesh.production_layout()
    rec = dryrun.executes(registry.get(arch), layout)
    assert rec["experts"] == (["model"] if ep else [])
    assert rec["accounting_only"] == ["model"]
    assert rec["sharded"] == ["data"]
    assert ("experts over model" in rec["what"]) == ep


@pytest.mark.parametrize("mesh", ["pod16x16", "pod2x16x16"])
def test_pod_memory_term_reads_what_a_card_holds(mesh):
    """A weight- and cache-bound decode cell at full size on a pod: every
    card reads at least the parameters and caches it stores, and each
    weight whole over ``pod``/``data``, which FSDP gathers before a read;
    so the memory term is at least those bytes over the card's rate, and
    well above the one-card traffic spread evenly over the devices."""
    arch, shape = "smollm-135m", SHAPES[2]
    assert shape.kind == "decode"
    cfg = registry.get(arch)
    one = dryrun.run_cell(arch, shape.name, verbose=False)
    r = dryrun.run_cell(arch, shape.name, verbose=False, mesh=mesh)
    layout = tmesh.production_layout(multi_pod=mesh == "pod2x16x16")
    parts = r["argument_parts"]
    assert r["t_memory"] >= (parts["params"] + parts["caches"]) / rl.HBM_BW
    named = dict(specs.abstract_model(cfg).named_parameters())
    model_only = {k: tuple(e if e == "model" else None for e in v)
                  for k, v in specs.param_shardings(cfg, layout).items()}
    read = specs.tree_bytes(named, model_only, layout)
    assert read > parts["params"]
    assert r["bytes_per_device"] >= read
    assert r["bytes_per_device"] > 2 * one["bytes_per_device"] / layout.size


def test_tally_groups_weight_cache_and_state_bytes():
    """The tally's groups: a marked weight's reads, and the reads and
    writes of what is computed from it alone (its transpose, its cast);
    a marked cache's in-place write; every byte inside ``state()``."""
    meta = torch.device("meta")
    w = torch.empty(16, 8, device=meta)
    cache = torch.empty(4, 16, device=meta)
    x = torch.empty(4, 8, device=meta)
    tally = OpTally()
    tally.mark([w], "weights")
    tally.mark([cache], "caches")
    with tally:
        y = x @ w.t()                        # reads w: 512
        wb = w.to(torch.bfloat16)            # reads 512, writes 256
        cache.copy_(y)                       # cache read and written: 512
        with tally.state():
            w.add_(torch.empty_like(w))      # all 1536 bytes: state
    assert wb.dtype == torch.bfloat16
    assert dict(tally.bytes_by_group) == {"weights": 512 + 768,
                                          "caches": 512, "state": 1536}
    assert tally.bytes == (128 + 512 + 256) + 768 + (512 + 256) + 1536


# ---------------------------------------------------------------------------
# The port stands alone
# ---------------------------------------------------------------------------

def test_package_imports_neither_jax_nor_the_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.M)
    bad = []
    for root, _, files in os.walk(SRC):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    for m in pat.finditer(f.read()):
                        bad.append(f"{path}: {m.group(0).strip()}")
    assert not bad, bad
