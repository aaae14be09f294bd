"""The port's serving CLI (`python -m repro_torch.launch.serve`) and serving
bench (`python -m repro_torch.launch.bench_serving`), in process on the
CPU (`--device cpu`), on the cases of the reference's
`tests/test_launch_serve.py`: a paged trace with armed faults and the
telemetry JSON; `--trace-out` with the periodic metrics flusher, its Chrome
trace passing the reference's validator; two replicas behind the router;
bad geometry. Also: the flags of parts not ported exit with a message
naming the ROADMAP item, the recurrent archs serve on the dense pool, a
checkpoint directory restores the newest valid step, and the bench prints
the reference bench's rows."""

import json
import threading

import pytest
import torch

from repro.obs.validate import validate_chrome_trace as jvalidate
from repro_torch.launch import bench_serving
from repro_torch.launch import serve as serve_cli
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

ARCH = "smollm-135m-smoke"


def _run(*argv):
    return serve_cli.main(["--device", "cpu", "--arch", ARCH, *argv])


def test_cli_paged_trace_with_armed_faults(tmp_path, capsys):
    out = tmp_path / "metrics.json"
    doc = _run("--requests", "3", "--slots", "2", "--max-len", "48",
               "--max-new", "4", "--pool", "paged", "--fault-seed", "0",
               "--fault-rate", "0.05", "--metrics-json", str(out))
    text = capsys.readouterr().out
    assert "[serve]" in text and "ttft" in text and "device=cpu" in text
    assert "[serve] lifecycle:" in text
    assert json.loads(out.read_text()) == json.loads(json.dumps(doc))
    assert doc["schema"] == "repro.serve/telemetry-1"
    snap = doc["summary"]
    assert snap["requests_finished"] == 3
    assert snap["pool"]["kind"] == "paged"
    assert snap["ttft_ms"]["p50"] <= snap["ttft_ms"]["p95"]
    metrics = doc["metrics"]
    assert metrics["schema"] == "repro.obs/v1"
    fam = metrics["metrics"]["serve_requests_finished_total"]
    assert fam["samples"][0]["value"] == 3
    assert "serve_fault_calls_total" in metrics["metrics"]


def test_cli_trace_out_and_metrics_interval(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    out = tmp_path / "metrics.json"
    _run("--requests", "3", "--slots", "2", "--max-len", "48",
         "--max-new", "4", "--prefill-chunk", "8", "--admission",
         "incremental", "--trace-out", str(trace), "--metrics-json",
         str(out), "--metrics-interval", "0.05")
    assert f"wrote {trace}" in capsys.readouterr().out
    doc = json.loads(trace.read_text())
    events = jvalidate(doc)                       # the reference's gate
    names = {e["name"] for e in events}
    assert {"queue", "admit", "tick", "finish", "compile", "decode",
            "prefill_chunk"} <= names
    assert len([e for e in events if e["name"] == "finish"]) == 3
    assert {e["tid"] for e in events} >= {0, 1, 2, 3}
    assert json.loads(out.read_text())["summary"]["requests_finished"] == 3


def test_cli_two_replicas_writes_router_snapshot(tmp_path, capsys,
                                                monkeypatch):
    """Two replicas behind the router: both serve, and the snapshot, the
    metrics and the trace name both. The trace's arrivals (50 req/s) are
    all submitted before the replicas' first tick, so that the router's
    least-outstanding dispatch (ties to the lowest index) splits the four
    requests 2/2 on any host: replayed against live ticks, a replica that
    finishes each request before the next arrives (a fast host, or a
    replay thread held back by a loaded one) gets all four."""
    from repro_torch.obs.validate import validate_chrome_trace
    from repro_torch.serve import Router, trace as ttrace
    submitted = threading.Event()
    replay, step = ttrace.replay, Router.step

    def replay_then_tick(*args, **kw):
        try:
            return replay(*args, **kw)
        finally:
            submitted.set()

    def step_after_replay(self, *args, **kw):
        assert submitted.wait(timeout=120)
        return step(self, *args, **kw)
    monkeypatch.setattr(ttrace, "replay", replay_then_tick)
    monkeypatch.setattr(Router, "step", step_after_replay)
    out = tmp_path / "router.json"
    trace = tmp_path / "router_trace.json"
    _run("--requests", "4", "--slots", "2", "--max-len", "48",
         "--max-new", "4", "--replicas", "2", "--rate", "50", "--mix",
         "bimodal", "--trace-out", str(trace), "--metrics-json", str(out))
    text = capsys.readouterr().out
    assert "replicas=2" in text and "[serve] router:" in text
    doc = json.loads(out.read_text())
    snap = doc["summary"]
    assert snap["replicas"] == 2 and snap["requests_finished"] == 4
    assert [p["dispatched"] for p in snap["per_replica"]] == [2, 2]
    assert all(p["dead"] is None for p in snap["per_replica"])
    assert {"p50", "p95"} <= set(snap["latency_ms"])
    fam = doc["metrics"]["metrics"]["serve_requests_finished_total"]
    assert {s["labels"]["replica"] for s in fam["samples"]} == {"0", "1"}
    assert sum(s["value"] for s in fam["samples"]) == 4
    assert "router_passes_total" in doc["metrics"]["metrics"]
    tdoc = json.loads(trace.read_text())
    events = jvalidate(tdoc)
    assert validate_chrome_trace(tdoc) == events
    assert len([e for e in events if e["name"] == "finish"]) == 4
    assert {e["pid"] for e in events if e["name"] == "tick"} == {0, 1}


def test_cli_rejects_bad_geometry():
    with pytest.raises(SystemExit, match="no valid prompt length"):
        _run("--requests", "2", "--max-len", "16", "--max-new", "14",
             "--min-prompt", "8")
    with pytest.raises(SystemExit, match="--replicas"):
        _run("--replicas", "0")


@pytest.mark.parametrize("flags", [
    ("--mesh-shape", "2x4"), ("--simulated-devices", "8", "--mesh-shape",
                              "8")])
def test_cli_refuses_unported_flags(flags, monkeypatch):
    """The mesh flags are the reference's (ROADMAP 6b): a ``(pod, data)``
    mesh of 8 in this one-rank process is refused before any request,
    naming both ways to get the ranks, and so is a mesh on the dense
    arch; ``--simulated-devices 8`` hands its 8 CPU ranks to
    ``spawn_ranks`` with the butterfly config's mesh (run for real in
    ``tests/test_torch_rehearsal_mesh.py`` and
    ``tests/test_torch_sharded_serve.py``)."""
    bfly = ["--arch", "smollm-135m-butterfly-smoke"]
    with pytest.raises(SystemExit, match="needs a butterfly arch"):
        _run(*flags)
    if flags[0] == "--mesh-shape":
        with pytest.raises(RuntimeError, match=r"butterfly mesh_shape "
                           r"\(2, 4\) needs 8 ranks but the world has 1"):
            _run(*flags, *bfly)
        return
    from repro_torch.runtime import dist as rdist
    calls = []
    monkeypatch.setattr(rdist, "spawn_ranks", lambda n, fn, *a, **k: (
        calls.append((n, fn, a, k)) or ["rank 0's document"]))
    assert _run(*flags, *bfly) == "rank 0's document"
    (n, fn, (args, cfg), kw), = calls
    assert (n, fn, kw) == (8, serve_cli._serve, {"device": "cpu"})
    assert cfg.name == "smollm-135m-butterfly-smoke"
    assert cfg.butterfly.mesh_shape == (8,)
    assert args.simulated_devices == 8 and args.mesh_shape == "8"


@pytest.mark.parametrize("flags,kind,chunk", [
    (("--pool", "dense"), "dense", None),
    (("--prefill-chunk", "0"), "paged", None)])
def test_cli_serves_dense_pool_and_whole_prompts(flags, kind, chunk, capsys):
    """The flags the CLI refused before the dense pool and whole-prompt
    admission were ported now serve every request."""
    doc = _run("--requests", "3", "--max-new", "3", *flags)
    out = capsys.readouterr().out
    assert f"pool={kind} chunk={chunk} " in out
    assert doc["summary"]["requests_finished"] == 3
    assert doc["summary"]["pool"]["kind"] == kind
    assert doc["summary"]["chunk_ticks"] == 0


@pytest.mark.parametrize("arch", ["recurrentgemma-2b-smoke",
                                  "xlstm-125m-butterfly-smoke"])
def test_cli_serves_the_recurrent_archs(arch, capsys):
    """The recurrent archs through the CLI: the paged request falls back
    to the dense pool, whole prompts at their exact lengths."""
    doc = serve_cli.main(["--device", "cpu", "--arch", arch, "--requests",
                          "3", "--max-new", "3", "--min-prompt", "1",
                          "--max-prompt", "20"])
    assert "pool=dense chunk=None " in capsys.readouterr().out
    assert doc["summary"]["requests_finished"] == 3
    assert doc["summary"]["chunk_ticks"] == 0


def test_cli_restores_newest_valid_checkpoint(tmp_path, capsys):
    """A port-written checkpoint (the trainer's layout) with its newest
    step torn: the CLI restores the older one and serves its weights."""
    from repro_torch import convert
    from repro_torch.checkpoint.checkpointing import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.serve import loader, tear_checkpoint
    cfg = registry.get(ARCH)
    model = loader.init_params(cfg, seed=7, device="cpu")
    tree = {"params": convert.to_jax_params(dict(model.named_parameters()),
                                          cfg)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, tree)
    mgr.save(4, tree)
    tear_checkpoint(str(tmp_path))
    _run("--requests", "1", "--max-new", "2", "--checkpoint-dir",
         str(tmp_path))
    assert "params: checkpoint step 3" in capsys.readouterr().out
    step, restored = loader.load_for_serving(cfg, str(tmp_path), seed=0,
                                             device="cpu")
    assert step == 3
    for (n, a), b in zip(model.state_dict().items(),
                         restored.state_dict().values()):
        assert torch.equal(a, b), n
    assert loader.restore_params(cfg, str(tmp_path / "absent")) == \
        (None, None)


def test_bench_serving_rows(tmp_path, capsys):
    out = tmp_path / "rows.json"
    assert bench_serving.main(["--device", "cpu", "--requests", "8",
                               "--max-new", "4", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    doc = json.loads(out.read_text())
    assert doc["device"] == "cpu"
    rows = {r["name"]: r for r in doc["rows"]}
    assert list(rows) == ["serve/trace_e2e", "serve/paged_e2e",
                          "serve/preempt_overload", "serve/spec_decode",
                          "serve/router_slo", "serve/chrome_trace",
                          "serve/large_pool"]
    assert rows["serve/large_pool"]["skipped"] and "status=skipped" in \
        rows["serve/large_pool"]["derived"]
    assert "occupancy=" in rows["serve/trace_e2e"]["derived"]
    for name in ("serve/trace_e2e", "serve/paged_e2e",
                 "serve/preempt_overload", "serve/spec_decode",
                 "serve/router_slo"):
        assert rows[name]["us_per_call"] > 0
        assert f"{name},{rows[name]['us_per_call']:.2f}," in text
    assert "requests=8" in rows["serve/router_slo"]["derived"]
    assert "status=artifact" in rows["serve/chrome_trace"]["derived"]
    jvalidate(json.loads((tmp_path / "serve_trace.json").read_text()))
