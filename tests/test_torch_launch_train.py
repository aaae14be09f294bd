"""The port's training entry point (`repro_torch.launch.train`), gradient
compression (`repro_torch.optim.compression`) and the Trainer's execution
record, against the JAX reference on the CPU.

Compression: the same gradients through the reference's transform and the
port's, 3 updates, compressed gradients and error buffers at 1e-6; the
port's per-layer leaves grouped as the reference's stacked ``unit`` leaf
give the stacked leaf's result. The CLI takes the reference's flags,
refuses its XLA flags naming why, takes its multi-device flags' paths, and
trains on the CPU with ``--device cpu``. ``ExecutionRecord``: ``torch`` on the CPU,
``dense`` without butterfly sites.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import TrainConfig as JTrainConfig
from repro.optim import compression as jcomp
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ButterflyConfig, TrainConfig
from repro_torch.kernels.context import ExecutionContext, use_execution
from repro_torch.launch import train as train_cli
from repro_torch.optim import compression as tcomp
from repro_torch.train.trainer import ExecutionRecord, Trainer
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SMOKE = "smollm-135m-butterfly-smoke"


def _grads(rng, shapes):
    g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    # ties at the threshold: a leaf of repeated magnitudes keeps more than k
    g["ties"] = np.repeat(rng.integers(-3, 4, 6), 5).astype(np.float32)
    return g


SHAPES = {"w": (7, 5), "v": (9,), "s": (), "b": (3, 2, 8)}


@pytest.mark.parametrize("kind,ratio", [("topk", 0.2), ("int8", 0.01)])
def test_compression_matches_reference(kind, ratio):
    """Three updates of the error-feedback transform on the same
    gradients: the compressed gradients and the error buffers at 1e-6."""
    rng = np.random.default_rng(0)
    params = {k: np.zeros(s, np.float32) for k, s in
              dict(SHAPES, ties=(30,)).items()}
    jtx = jcomp.compress_gradients(kind, ratio)
    ttx = tcomp.compress_gradients(kind, ratio)
    js = jtx.init({k: jnp.asarray(v) for k, v in params.items()})
    ts = ttx.init({k: torch.from_numpy(v) for k, v in params.items()})
    for _ in range(3):
        g = _grads(rng, SHAPES)
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js)
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts)
        for k in g:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(ts.error[k].numpy(),
                                       np.asarray(js.error[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    # a 0-d leaf passes through and leaves no residual
    assert torch.equal(tu["s"], torch.from_numpy(g["s"]))
    assert float(ts.error["s"]) == 0.0
    if kind == "topk":      # the tied leaf keeps more than k entries
        assert int((tu["ties"] != 0).sum()) > max(1, int(ratio * 30))


@pytest.mark.parametrize("kind", ["topk", "int8"])
def test_grouped_layers_compress_as_the_stacked_leaf(kind):
    """Per-layer leaves in one group share the threshold or scale of the
    reference's stacked (R, ...) leaf."""
    rng = np.random.default_rng(1)
    R, shape = 3, (6, 4)
    jtx = jcomp.compress_gradients(kind, 0.1)
    ttx = tcomp.compress_gradients(
        kind, 0.1, group=lambda n: n.split(".", 2)[-1]
        if n.startswith("layers.") else n)
    names = [f"layers.{i}.w" for i in range(R)] + ["head"]
    js = jtx.init({"w": jnp.zeros((R,) + shape), "head": jnp.zeros(5)})
    ts = ttx.init({n: torch.zeros(shape if n != "head" else (5,))
                   for n in names})
    for _ in range(3):
        gw = rng.normal(size=(R,) + shape).astype(np.float32)
        gw[1] *= 10                     # one layer dominates the group
        gh = rng.normal(size=5).astype(np.float32)
        ju, js = jtx.update({"w": jnp.asarray(gw), "head": jnp.asarray(gh)},
                            js)
        tg = {f"layers.{i}.w": torch.from_numpy(gw[i]) for i in range(R)}
        tg["head"] = torch.from_numpy(gh)
        tu, ts = ttx.update(tg, ts)
        got = np.stack([tu[f"layers.{i}.w"].numpy() for i in range(R)])
        np.testing.assert_allclose(got, np.asarray(ju["w"]), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tu["head"].numpy(), np.asarray(ju["head"]),
                                   rtol=1e-6, atol=1e-6)
    if kind == "topk":
        assert not bool(tu["layers.0.w"].any())   # all kept in layer 1


@pytest.mark.parametrize("kind", ["topk", "int8", ""])
def test_compression_stats_match_reference(kind):
    for shape, dt in (((300, 7), np.float32), ((1000,), np.float16)):
        want = jcomp.compression_stats(kind, jnp.zeros(shape, dt), 0.01)
        got = tcomp.compression_stats(kind, torch.zeros(
            shape, dtype=getattr(torch, np.dtype(dt).name)), 0.01)
        assert got == want


def test_unknown_compression_is_refused():
    with pytest.raises(ValueError, match="unknown gradient compression"):
        tcomp.compress_gradients("fp8")


def test_reference_configs_construct_in_the_port():
    """Every ButterflyConfig and TrainConfig field the reference's smollm
    family sets constructs the port's configs."""
    for name in ("smollm-135m", "smollm-135m-butterfly",
                 "smollm-135m-butterfly-smoke"):
        bc = jreg.get(name).butterfly
        if bc is not None:
            port = ButterflyConfig(**dataclasses.asdict(bc))
            assert port == treg.get(name).butterfly
    jtc = JTrainConfig(grad_compression="int8", grad_compression_ratio=0.05,
                       log_every=3)
    assert dataclasses.asdict(TrainConfig(**dataclasses.asdict(jtc))) == \
        dataclasses.asdict(jtc)


def test_entry_points_load_neither_jax_nor_repro():
    code = ("import sys, repro_torch.launch.train, "
            "repro_torch.optim.compression; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=dict(os.environ, PYTHONPATH=SRC),
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# ExecutionRecord
# ---------------------------------------------------------------------------

TC = dict(learning_rate=3e-3, warmup_steps=2, total_steps=20,
          checkpoint_every=0)


def test_execution_record_on_the_cpu():
    res = Trainer(treg.get(SMOKE), TrainConfig(**TC), seq_len=16,
                  global_batch=2, device="cpu").run(1)
    assert isinstance(res.execution, ExecutionRecord)
    assert res.kernel_backend == res.execution.backend == "torch"
    assert res.kernel_tuning == "" and res.mesh_layout == ""
    assert res.execution.context.backend == "torch"
    assert res.execution.describe() == "backend=torch"


def test_execution_record_is_dense_without_butterfly_sites():
    res = Trainer(treg.get("smollm-135m-smoke"), TrainConfig(**TC),
                  seq_len=16, global_batch=2, device="cpu").run(1)
    assert res.kernel_backend == "dense" and res.execution.context is None
    assert res.execution.describe() == "dense"


def test_trainer_freezes_the_context_it_was_built_under():
    """Built inside ``use_execution``, the Trainer keeps that policy for
    its steps, whatever block is open when it runs; the config's segment
    rides along."""
    cfg = treg.get(SMOKE)
    cfg = cfg.with_(butterfly=dataclasses.replace(cfg.butterfly,
                                                  segment=2))
    with use_execution(ExecutionContext(backend="torch", profile=False)):
        tr = Trainer(cfg, TrainConfig(**TC), seq_len=16, global_batch=2,
                     device="cpu")
    with use_execution(ExecutionContext(backend="cuda", segment=5)):
        res = tr.run(1)
    assert res.execution.context == ExecutionContext(
        backend="torch", segment=2, profile=False)
    assert res.execution.describe() == \
        "backend=torch segment=2 profile=False"


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_parses_the_reference_command_line():
    """The reference's documented command line (its module docstring)."""
    args = train_cli._parser().parse_args(
        ["--arch", "smollm-135m-smoke", "--steps", "200", "--seq-len", "128",
         "--global-batch", "8", "--checkpoint-dir", "/tmp/ckpt"])
    assert (args.arch, args.steps, args.seq_len, args.global_batch,
            args.checkpoint_dir) == ("smollm-135m-smoke", 200, 128, 8,
                                     "/tmp/ckpt")
    defaults = train_cli._parser().parse_args(["--arch", "x"])
    assert (defaults.microbatches, defaults.lr, defaults.warmup_steps,
            defaults.weight_decay, defaults.grad_compression,
            defaults.checkpoint_every, defaults.seed) == \
        (1, 3e-4, 100, 0.1, "", 200, 0)


@pytest.mark.parametrize("flags,why", [
    (["--mesh-shape", "2x4"], "item 6"),
    (["--simulated-devices", "8"], "item 6"),
    (["--distributed"], "item 6"),
    (["--xla-perf-flags"], "no torch meaning")])
def test_cli_refuses_unported_flags(flags, why, monkeypatch, capsys):
    """``--xla-perf-flags`` exits: XLA's flags have no torch meaning. The
    multi-device flags (ROADMAP ``why``, its part 6a) take their paths: a
    ``(pod, data)`` mesh of 8 in this one-rank process raises naming both
    ways to get the ranks; ``--simulated-devices 8`` hands its 8 CPU ranks
    to ``spawn_ranks`` (run for real in
    ``tests/test_torch_sharded_train.py``); ``--distributed`` joins the
    world torchrun's variables describe, here one gloo rank, trains and
    leaves it."""
    argv = ["--arch", SMOKE, "--device", "cpu", "--steps", "1",
            "--seq-len", "8", "--global-batch", "2"] + flags
    if flags[0] == "--xla-perf-flags":
        with pytest.raises(SystemExit, match=why):
            train_cli.main(argv)
    elif flags[0] == "--mesh-shape":
        with pytest.raises(RuntimeError, match="butterfly mesh_shape "
                           r"\(2, 4\) needs 8 ranks but the world has 1"):
            train_cli.main(argv)
    elif flags[0] == "--simulated-devices":
        from repro_torch.runtime import dist as rdist
        calls = []
        monkeypatch.setattr(rdist, "spawn_ranks", lambda n, fn, *a, **k: (
            calls.append((n, fn, a, k)) or ["rank 0's result"]))
        assert train_cli.main(argv) == "rank 0's result"
        (n, fn, (args, cfg), kw), = calls
        assert (n, fn, kw, cfg.name) == (8, train_cli._train,
                                         {"device": "cpu"}, SMOKE)
        assert args.simulated_devices == 8
    else:
        from repro_torch.runtime import dist as rdist
        with pytest.raises(RuntimeError, match="missing RANK, WORLD_SIZE"):
            train_cli.main(argv)
        for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"),
                     ("MASTER_ADDR", "localhost"),
                     ("MASTER_PORT", str(rdist._free_port()))):
            monkeypatch.setenv(k, v)
        res = train_cli.main(argv)
        assert res.steps_run == 1 and rdist.current_world() is None
        assert not torch.distributed.is_initialized()
        assert (f"[train] {SMOKE} | 1 process(es), 1 device(s) (cpu, gloo)"
                in capsys.readouterr().out)


def test_cli_refuses_archs_the_port_lacks(capsys):
    """Every registry arch trains, the vision frontend's among them (its
    batches carry the trainer's stub embeddings); an unknown name exits."""
    res = train_cli.main(["--arch", "internvl2-1b-smoke", "--steps", "2",
                          "--seq-len", "8", "--global-batch", "2",
                          "--device", "cpu"])
    assert res.steps_run == 2 and all(np.isfinite(res.losses))
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "[train] done: loss ")
    with pytest.raises(SystemExit, match="unknown architecture"):
        train_cli.main(["--arch", "internvl2-1b-tiny", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["recurrentgemma-2b-butterfly-smoke",
                                  "xlstm-125m-butterfly-smoke"])
def test_cli_trains_the_recurrent_archs_on_the_cpu(arch, capsys):
    """RG-LRU with local attention, and mLSTM/sLSTM, through the CLI on
    sequences past the mLSTM's chunk of 16 and recurrentgemma's window."""
    res = train_cli.main(["--arch", arch, "--steps", "2", "--seq-len", "24",
                          "--global-batch", "2", "--device", "cpu"])
    assert res.steps_run == 2 and all(np.isfinite(res.losses))
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "[train] done: loss ")


def test_cli_trains_gemma3_on_the_cpu(capsys):
    """gemma3's unit of five `local` blocks and one `global`, with its
    two-layer `local` tail, trains through the CLI (sequences past its
    16-token window)."""
    res = train_cli.main(["--arch", "gemma3-27b-smoke", "--steps", "2",
                          "--seq-len", "24", "--global-batch", "2",
                          "--device", "cpu"])
    assert res.steps_run == 2 and all(np.isfinite(res.losses))
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "[train] done: loss ")


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", SMOKE, "--steps", "3", "--seq-len", "16",
            "--global-batch", "2", "--warmup-steps", "2",
            "--checkpoint-every", "2", "--checkpoint-dir", str(tmp_path),
            "--device", "cpu"]
    res = train_cli.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"[train] {SMOKE} | 1 process(es), 1 device(s) "
                             f"(cpu) | steps=3 seq=16 batch=2 µb=1")
    assert out[-1].startswith("[train] done: loss ")
    assert "; exec [backend=torch]" in out[-1]
    assert "resumed" not in out[-1]
    assert res.steps_run == 3 and res.resumed_from is None
    assert all(np.isfinite(res.losses))
    # the same directory again resumes from the newest checkpoint
    again = train_cli.main(argv[:3] + ["1"] + argv[4:])
    assert again.resumed_from == 2
    assert "resumed from step 2" in capsys.readouterr().out
