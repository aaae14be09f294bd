"""The port's Trainer on a `(2,)` butterfly data mesh against the
reference's unsharded Trainer, on the CPU (two gloo ranks).

`smollm-135m-butterfly-smoke` in float32 compute, weights from the
reference's init carried over with `repro_torch.convert`, seq 32 at global
batches 8 and 5, 4 steps; `ButterflyConfig.mesh_shape=(2,)` shards every
butterfly site's rows over the two ranks. Held at the reference's own
tolerances for its sharded run against its unsharded one
(`tests/test_trainer_integration.py`): the first loss at rtol 1e-4, all
losses at rtol 5e-3 / atol 1e-4. The ranks' parameters must be equal bit
for bit, the record must say `data=2`, rank 0 alone writes a checkpoint
and both ranks resume from it. The training CLI's `--simulated-devices 2
--mesh-shape 2 --device cpu` runs, a failed rank fails it, and
`--mesh-shape`'s messages are the reference's.
"""

import concurrent.futures
import dataclasses
import functools
import sys

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.runtime import pytree as pt
from repro.train.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.launch import train as train_cli
from repro_torch.runtime import dist as rdist
from test_torch_chip_smoke import one_torch_thread  # noqa: F401
from test_torch_lm import reference_site_specs

import _torch_mesh_ranks as ranks

ARCH = "smollm-135m-butterfly-smoke"
TC = dict(learning_rate=3e-3, warmup_steps=2, total_steps=20,
          checkpoint_every=0)
RUNS = ((8, 4), (5, 4))          # (global batch, steps)


@functools.lru_cache(maxsize=None)
def _reference_init():
    jcfg = jreg.get(ARCH).with_(compute_dtype="float32")
    params = pt.init_params(jax.random.PRNGKey(0), jlm.model_specs(jcfg))
    return jcfg, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's unsharded losses at each of RUNS, and each rank's
    sharded runs and checkpoint check (on a thread of their own while the
    reference trains)."""
    jcfg, params_np = _reference_init()
    bc = treg.get(ARCH).butterfly
    tcfg = treg.get(ARCH).with_(
        compute_dtype="float32",
        butterfly=dataclasses.replace(bc, mesh_shape=(2,)))
    specs = {k: convert.butterfly_spec_from_jax(s)
             for k, s in reference_site_specs(jcfg).items()}
    ckdir = str(tmp_path_factory.mktemp("mesh_ckpt"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        sharded = pool.submit(rdist.spawn_ranks, 2, ranks.train_runs, tcfg,
                              params_np, specs, RUNS, ckdir, device="cpu",
                              threads=1)
        want = {}
        for batch, steps in RUNS:
            trainer = JTrainer(jcfg, JTrainConfig(**TC), seq_len=32,
                               global_batch=batch)
            start = jax.tree_util.tree_map(np.array, params_np)
            want[batch] = trainer.run(steps, params=start,
                                      opt_state=trainer.tx.init(start)
                                      ).losses
        return want, sharded.result()


@pytest.mark.parametrize("i", range(len(RUNS)),
                         ids=[f"batch{b}" for b, _ in RUNS])
def test_sharded_trainer_matches_reference(runs, i):
    want, per_rank = runs
    batch, steps = RUNS[i]
    for got in (r["runs"][i] for r in per_rank):
        assert len(got["losses"]) == steps
        assert got["layout"] == "data=2"
        assert got["exec"] == "backend=torch mesh=data=2"
        np.testing.assert_allclose(got["losses"][0], want[batch][0],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["losses"], want[batch], rtol=5e-3,
                                   atol=1e-4)


@pytest.mark.parametrize("i", range(len(RUNS)),
                         ids=[f"batch{b}" for b, _ in RUNS])
def test_ranks_parameters_bit_identical(runs, i):
    r0, r1 = (r["runs"][i] for r in runs[1])
    assert r0["digest"] == r1["digest"]
    assert r0["losses"] == r1["losses"]


def test_checkpoint_written_by_rank_0_and_resumed_by_both(runs):
    _, per_rank = runs
    c0, c1 = (r["ckpt"] for r in per_rank)
    assert c0["saves"] == [2] and c1["saves"] == []
    assert c0["files"] == c1["files"] and len(c0["files"]) >= 1
    continuous = per_rank[0]["runs"][0]["losses"]      # batch 8, 4 steps
    for c in (c0, c1):
        assert c["resumed_from"] == 2
        np.testing.assert_allclose(c["head"], continuous[:2], rtol=1e-6)
        np.testing.assert_allclose(c["tail"], continuous[2:], rtol=1e-6)


def test_cli_trains_on_simulated_devices(capfd):
    """Rank 0 prints the start line with the world and the done line with
    the mesh; rank 1 prints nothing; main returns rank 0's result."""
    res = train_cli.main(["--arch", ARCH, "--device", "cpu",
                          "--simulated-devices", "2", "--mesh-shape", "2",
                          "--steps", "2", "--seq-len", "16",
                          "--global-batch", "3", "--checkpoint-every", "0"])
    out = capfd.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("[train]")]
    assert len(lines) == 2, out
    assert lines[0].startswith(f"[train] {ARCH} | 2 process(es), 2 "
                               f"device(s) (cpu, gloo) | steps=2 seq=16 "
                               f"batch=3")
    assert lines[1].startswith("[train] done: loss ")
    assert lines[1].endswith("exec [backend=torch mesh=data=2]")
    assert res.mesh_layout == "data=2" and len(res.losses) == 2
    assert res.execution.context.mesh_layout() == "data=2"


def test_cli_failed_rank_fails_the_run():
    """A mesh larger than the ranks raises in every rank; the parent raises
    with the first failed rank's traceback and stops the others."""
    with pytest.raises(RuntimeError) as e:
        train_cli.main(["--arch", ARCH, "--device", "cpu",
                        "--simulated-devices", "2", "--mesh-shape", "4",
                        "--steps", "1", "--seq-len", "16",
                        "--global-batch", "2"])
    msg = str(e.value)
    assert " of 2 failed:" in msg and "Traceback" in msg
    assert "butterfly mesh_shape (4,) needs 4 ranks but the world has 2" \
        in msg


@pytest.mark.parametrize("arch,shape", [
    ("smollm-135m-smoke", "2"), (ARCH, "2xa"), (ARCH, "0"), (ARCH, "x")])
def test_cli_mesh_shape_messages_are_the_reference(monkeypatch, arch, shape):
    """A dense arch and a malformed shape exit with the reference's
    messages, before any rank starts."""
    flags = ["--arch", arch, "--mesh-shape", shape]
    monkeypatch.setattr(sys, "argv", ["train"] + flags)
    with pytest.raises(SystemExit) as want:
        jtrain.main()
    with pytest.raises(SystemExit) as got:
        train_cli.main(flags + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "--mesh-shape" in str(got.value)
