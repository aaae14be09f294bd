"""The port's training checkpoints against the JAX reference's, on
`smollm-135m-butterfly-smoke` in float32: a run cut after a checkpoint and
resumed (the port's own checkpoints, and an async one written after the
next step has updated the params in place), the port resuming from the
reference Trainer's step-2 checkpoint and the reference resuming from the
port's (with and without gradient compression's slot in the optimizer's
chain), and the optimizer state through the reference's layout. Split
from `test_torch_train.py`, whose helpers and shared reference runs it
uses; tolerances as there (4-step losses at rtol 1e-4).
"""

import math
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.checkpoint import checkpointing as tckpt
from repro_torch.configs.base import TrainConfig
from repro_torch.models import lm as tlm
from repro_torch.train import steps as tsteps
from repro_torch.train.trainer import Trainer
from test_torch_chip_smoke import one_torch_thread  # noqa: F401
from test_torch_train import (TC, _configs, _port_model, _reference_params,
                              reference_runs)  # noqa: F401


def test_resume_from_own_checkpoint(tmp_path):
    """A run cut after a checkpoint and resumed gives the losses of the
    uncut run: params, Adam moments and step counts round-trip."""
    _, tcfg = _configs()
    tc = TrainConfig(**dict(TC, checkpoint_every=2),
                     checkpoint_dir=str(tmp_path / "ck"))
    whole = Trainer(tcfg, TrainConfig(**TC), seq_len=16, global_batch=2,
                    device="cpu").run(4)
    Trainer(tcfg, tc, seq_len=16, global_batch=2, device="cpu").run(2)
    rest = Trainer(tcfg, tc, seq_len=16, global_batch=2,
                   device="cpu").run(2)
    assert rest.resumed_from == 2
    np.testing.assert_allclose(rest.losses, whole.losses[2:], rtol=1e-6)
    assert all(math.isfinite(v) for v in whole.losses)


def test_async_checkpoint_holds_its_own_step(tmp_path):
    """Step 1's checkpoint, written on its thread only after step 2 has
    updated the params and Adam's moments in place, holds step 1's own
    params and moments: the host snapshot shares no memory with them."""
    _, tcfg = _configs()
    tc = TrainConfig(**dict(TC, checkpoint_every=1),
                     checkpoint_dir=str(tmp_path / "ck"))
    trainer = Trainer(tcfg, tc, seq_len=16, global_batch=2, device="cpu")
    steps_done, second = [], threading.Event()
    step_fn, write = trainer.step_fn, trainer.ckpt._write

    def step_and_signal(*args):
        out = step_fn(*args)
        steps_done.append(len(steps_done) + 1)
        if len(steps_done) == 2:
            second.set()
        return out

    def write_after_step_two(step, tree, extra):
        if step == 1:
            second.wait(timeout=120)
        write(step, tree, extra)

    trainer.step_fn = step_and_signal
    trainer.ckpt._write = write_after_step_two
    trainer.run(2)
    assert second.is_set()
    assert tckpt.CheckpointManager(tc.checkpoint_dir).steps() == [1, 2]
    one = Trainer(tcfg, TrainConfig(**TC), seq_len=16, global_batch=2,
                  device="cpu")
    one.run(1)
    want = {"params": convert.to_jax_params(
                tsteps.trainable(one.model), tcfg),
            "opt": convert.opt_state_to_jax(one.opt_state, tcfg)}
    step, got, _ = tckpt.load_latest(tc.checkpoint_dir, want, step=1)
    assert step == 1
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert any("embed" in jax.tree_util.keystr(p) for p, _ in leaves)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for (path, w), g in zip(leaves, jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module", params=["", "topk"])
def reference_resume_run(request, tmp_path_factory, reference_runs):
    """The reference Trainer, 4 steps from the reference init with a
    checkpoint every 2 (with and without the compression slot in the
    optimizer's chain); returns its losses and a directory holding its
    step-2 checkpoint alone."""
    jcfg, tcfg = _configs()
    params, params_np = _reference_params(jcfg)
    tc = dict(TC, checkpoint_every=2, grad_compression=request.param)
    losses, ckdir = reference_runs(request.param)
    step2 = tmp_path_factory.mktemp("jax_step2")
    shutil.copytree(ckdir / "step_000000002", step2 / "step_000000002")
    return jcfg, tcfg, params, params_np, tc, losses, step2


def test_resumes_from_a_reference_checkpoint(reference_resume_run):
    """The port resumes from the step-2 checkpoint the reference's Trainer
    wrote, params and optimizer state, and its steps 3-4 match the
    reference's continuous run."""
    jcfg, tcfg, _, params_np, tc, want, step2 = reference_resume_run
    res = Trainer(tcfg, TrainConfig(**tc, checkpoint_dir=str(step2)),
                  seq_len=32, global_batch=4, device="cpu").run(
        2, model=_port_model(tcfg, jcfg, params_np))
    assert res.resumed_from == 2
    np.testing.assert_allclose(res.losses, want[2:], rtol=1e-4)


def test_reference_resumes_from_a_port_checkpoint(reference_resume_run,
                                                  tmp_path):
    """The reference resumes from the port's step-2 checkpoint and its
    steps 3-4 match its own continuous run."""
    jcfg, tcfg, params, params_np, tc, want, _ = reference_resume_run
    tc = dict(tc, checkpoint_dir=str(tmp_path))
    Trainer(tcfg, TrainConfig(**tc), seq_len=32, global_batch=4,
            device="cpu").run(2, model=_port_model(tcfg, jcfg, params_np))
    trainer = JTrainer(jcfg, JTrainConfig(**tc), seq_len=32, global_batch=4)
    start = jax.tree_util.tree_map(jnp.array, params)
    res = trainer.run(2, params=start, opt_state=trainer.tx.init(start))
    assert res.resumed_from == 2
    np.testing.assert_allclose(res.losses, want[2:], rtol=1e-4)


def test_optimizer_state_round_trips_the_reference_layout():
    """The optimizer state through the reference's layout and back is the
    same state: counts int32, the empty ClipState() slots in the tuple,
    the compression's error buffers stacked as ``unit`` like Adam's
    moments."""
    _, tcfg = _configs()
    model = tlm.LM(tcfg, generator=torch.Generator().manual_seed(0))
    tx = tsteps.make_optimizer(TrainConfig(**TC, grad_compression="int8"),
                               tcfg)
    params = tsteps.trainable(model)
    state = tx.init(params)
    grads = {n: torch.randn_like(p) for n, p in params.items()}
    _, state = tx.update(grads, state, params)
    host = convert.opt_state_to_jax(state, tcfg)
    assert [type(s).__name__ for s in host] == [
        "ClipState", "ErrorFeedbackState", "ScaleByAdamState", "ClipState",
        "ScaleByScheduleState"]
    assert host[2].count.dtype == np.int32 and host[2].count.shape == ()
    stacked = host[1].error["unit"][0]["ffn"]["up"]["b_in"]
    assert stacked.shape[0] == tcfg.n_layers
    back = convert.load_jax_opt_state(tcfg, state, host)
    flat_a = tckpt._flatten(tckpt._to_host(state))
    flat_b = tckpt._flatten(tckpt._to_host(back))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=k)
