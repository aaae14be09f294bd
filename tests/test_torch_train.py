"""The port's training path against the JAX reference, on
`smollm-135m-butterfly-smoke` in float32 (`compute_dtype="float32"`).

Weights come from the reference's own init and are carried into the port
with `repro_torch.convert.from_jax_params`; both see the same
`SyntheticLM` batches (the port's pipeline is a byte-identical copy).
Tolerances: step-1 loss and per-leaf gradients at atol 1e-5, rtol 1e-4;
4-step Trainer losses at rtol 1e-4 (the two frameworks sum in different
orders); attention outputs at 1e-5.
"""

import math
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointing as jckpt
from repro.configs import registry as jreg
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import for_model as jfor_model
from repro.models import attention as jattn
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.optim import optimizer as jopt
from repro.runtime import pytree as pt
from repro.train import steps as jsteps
from repro.train.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.checkpoint import checkpointing as tckpt
from repro_torch.configs import registry as treg
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import for_model
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.optim import optimizer as topt
from repro_torch.train import steps as tsteps
from repro_torch.train.trainer import Trainer
from test_torch_lm import reference_site_specs

ARCH = "smollm-135m-butterfly-smoke"
TC = dict(learning_rate=3e-3, warmup_steps=2, total_steps=20,
          checkpoint_every=0)


def _configs():
    return (jreg.get(ARCH).with_(compute_dtype="float32"),
            treg.get(ARCH).with_(compute_dtype="float32"))


def _reference_params(jcfg, seed=0):
    params = pt.init_params(jax.random.PRNGKey(seed), jlm.model_specs(jcfg))
    return params, jax.tree_util.tree_map(np.asarray, params)


def _port_model(tcfg, jcfg, params_np):
    return convert.from_jax_params(tcfg, params_np,
                                   reference_site_specs(jcfg), device="cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


@pytest.mark.parametrize("seq_len", [32, 64], ids=["masked", "blockwise"])
def test_step1_loss_and_grads_match_reference(seq_len):
    jcfg, tcfg = _configs()
    assert (seq_len >= tcfg.blockwise_threshold) == (seq_len == 64)
    params, params_np = _reference_params(jcfg)
    batch = jfor_model(jcfg, seq_len, 2, seed=0).batch(0)
    (loss, _), grads = jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, {k: jnp.asarray(v)
                                        for k, v in batch.items()}),
        has_aux=True)(params)
    model = _port_model(tcfg, jcfg, params_np)
    tloss, tgrads = tsteps.loss_and_grads(model, _torch_batch(batch))
    np.testing.assert_allclose(float(tloss), float(loss), atol=1e-5,
                               rtol=1e-4)
    port = convert.to_jax_params(tgrads, tcfg)
    leaves = jax.tree_util.tree_leaves_with_path(grads)
    assert len(leaves) == len(convert.names_by_reference_key(tgrads, tcfg))
    for path, want in leaves:
        np.testing.assert_allclose(_leaf(port, path), np.asarray(want),
                                   atol=1e-5, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("seq_len", [32, 64], ids=["masked", "blockwise"])
def test_train_attention_matches_reference(seq_len):
    jcfg, tcfg = _configs()
    params, params_np = _reference_params(jcfg, seed=1)
    model = _port_model(tcfg, jcfg, params_np)
    x = np.random.default_rng(seq_len).normal(
        size=(2, seq_len, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(seq_len), (2, seq_len))
    attn_params = jax.tree_util.tree_map(lambda a: a[0],
                                         params["unit"][0]["attn"])
    want, _ = jattn.attention(jcfg, attn_params, jnp.asarray(x),
                              positions=jnp.asarray(pos), mode="train")
    with torch.no_grad():
        got = tattn.attention(tcfg, model.layers[0].attn,
                              torch.from_numpy(x),
                              positions=torch.from_numpy(pos.copy()).int())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_masked_and_blockwise_attention_agree():
    _, tcfg = _configs()
    gen = torch.Generator().manual_seed(0)
    B, S, KV, G, D = 2, 64, 2, 2, 16
    q = torch.randn(B, S, KV, G, D, generator=gen)
    k = torch.randn(B, S, KV, D, generator=gen)
    v = torch.randn(B, S, KV, D, generator=gen)
    pos = torch.arange(S).expand(B, S)
    torch.testing.assert_close(
        tattn._attend_blockwise(q, k, v, block_q=16, block_kv=32),
        tattn._attend_masked(q, k, v, pos, pos), atol=1e-5, rtol=1e-5)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jcm.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if m is None else jnp.asarray(m))
        got = tcm.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_optimizer_matches_reference():
    """Three updates of the trainer's optimizer (clip, Adam, decay,
    warmup-cosine) on random params and grads."""
    tc = TrainConfig(**TC, max_grad_norm=0.5)
    jtc = JTrainConfig(**TC, max_grad_norm=0.5)
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 3), "v": (5,), "b": (2, 2, 4)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    _, tcfg = _configs()
    jtx, ttx = jsteps.make_optimizer(jtc), tsteps.make_optimizer(tc, tcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for i in range(3):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts, tp)
        topt.apply_updates(tp, tu)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference Trainer: 4 steps from the reference init, a checkpoint
    at step 4."""
    jcfg, tcfg = _configs()
    params, params_np = _reference_params(jcfg)
    ckdir = str(tmp_path_factory.mktemp("jax_ckpt"))
    jtc = JTrainConfig(**dict(TC, checkpoint_every=4), checkpoint_dir=ckdir)
    trainer = JTrainer(jcfg, jtc, seq_len=32, global_batch=4)
    start = jax.tree_util.tree_map(jnp.array, params)
    res = trainer.run(4, params=start, opt_state=trainer.tx.init(start))
    return jcfg, tcfg, params_np, res.losses, ckdir


def test_trainer_losses_match_reference_over_4_steps(reference_run):
    jcfg, tcfg, params_np, want, _ = reference_run
    model = _port_model(tcfg, jcfg, params_np)
    res = Trainer(tcfg, TrainConfig(**TC), seq_len=32, global_batch=4,
                  device="cpu").run(4, model=model)
    assert res.steps_run == 4 and len(res.step_times) == 4
    # the straggler record: an EMA of the step times lies within them
    assert min(res.step_times) <= res.step_time_ema <= max(res.step_times)
    np.testing.assert_allclose(res.losses, want, rtol=1e-4)


def test_loads_params_of_a_reference_checkpoint(reference_run):
    jcfg, tcfg, params_np, _, ckdir = reference_run
    model = _port_model(tcfg, jcfg, params_np)
    tmpl = {"params": convert.to_jax_params(dict(model.named_parameters()),
                                          tcfg)}
    step, tree, extra = tckpt.load_latest(ckdir, tmpl)
    assert step == 4 and "loss" in extra
    convert.load_jax_params(model, tree["params"])
    jstep, jtree, _ = jckpt.load_latest(
        ckdir, {"params": jax.tree_util.tree_map(jnp.asarray, params_np)})
    assert jstep == 4
    batch = jfor_model(jcfg, 32, 2, seed=5).batch(0)
    want, _ = jlm.loss_fn(jcfg, jtree["params"],
                          {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, _ = tlm.loss_fn(model, _torch_batch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    table = tree["params"]["embed"]["table"]
    assert torch.equal(model.embed.table, torch.from_numpy(table))
    assert not np.array_equal(table, params_np["embed"]["table"])


def test_microbatches_match_one_batch():
    """Two microbatches give the same update as one batch (the reference's
    `test_grad_accumulation_equivalence`)."""
    _, tcfg = _configs()
    models = [tlm.LM(tcfg, generator=torch.Generator().manual_seed(0))
              for _ in range(2)]
    tx = topt.sgd(0.1)
    batch = _torch_batch(for_model(tcfg, 32, 4, seed=3).batch(0))
    metrics = []
    for model, mb in zip(models, (1, 2)):
        step = tsteps.make_train_step(tcfg, tx, microbatches=mb)
        params = tsteps.trainable(model)
        _, m = step(model, tx.init(params), batch)
        metrics.append(m)
    np.testing.assert_allclose(float(metrics[0]["loss"]),
                               float(metrics[1]["loss"]), rtol=1e-5)
    for (name, a), b in zip(models[0].named_parameters(),
                            models[1].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


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


def test_trainer_needs_a_card_unless_asked_for_cpu():
    _, tcfg = _configs()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tcfg, TrainConfig(**TC), seq_len=16, global_batch=2)
    Trainer(tcfg, TrainConfig(**TC), seq_len=16, global_batch=2,
            device="cpu")
    # gradient compression is ported; an unknown codec is refused
    Trainer(tcfg, TrainConfig(**TC, grad_compression="topk"),
            seq_len=16, global_batch=2, device="cpu")
    with pytest.raises(ValueError, match="unknown gradient compression"):
        Trainer(tcfg, TrainConfig(**TC, grad_compression="fp8"),
                seq_len=16, global_batch=2, device="cpu")


@pytest.mark.parametrize("kind", ["topk", "int8"])
def test_trainer_with_compression_matches_reference_over_4_steps(kind):
    """Gradient compression before Adam: the port's Trainer against the
    reference's over 4 steps, at the 4-step test's tolerance."""
    jcfg, tcfg = _configs()
    params, params_np = _reference_params(jcfg)
    jtc = JTrainConfig(**TC, grad_compression=kind)
    trainer = JTrainer(jcfg, jtc, seq_len=32, global_batch=4)
    start = jax.tree_util.tree_map(jnp.array, params)
    want = trainer.run(4, params=start, opt_state=trainer.tx.init(start))
    res = Trainer(tcfg, TrainConfig(**TC, grad_compression=kind), seq_len=32,
                  global_batch=4, device="cpu").run(
        4, model=_port_model(tcfg, jcfg, params_np))
    np.testing.assert_allclose(res.losses, want.losses, rtol=1e-4)


@pytest.fixture(scope="module", params=["", "topk"])
def reference_resume_run(request, tmp_path_factory):
    """The reference Trainer, 4 steps from the reference init with a
    checkpoint every 2 (with and without the compression slot in the
    optimizer's chain); returns its losses and a directory holding its
    step-2 checkpoint alone."""
    jcfg, tcfg = _configs()
    params, params_np = _reference_params(jcfg)
    tc = dict(TC, checkpoint_every=2, grad_compression=request.param)
    ckdir = tmp_path_factory.mktemp("jax_resume")
    trainer = JTrainer(jcfg, JTrainConfig(**tc, checkpoint_dir=str(ckdir)),
                       seq_len=32, global_batch=4)
    start = jax.tree_util.tree_map(jnp.array, params)
    res = trainer.run(4, params=start, opt_state=trainer.tx.init(start))
    step2 = tmp_path_factory.mktemp("jax_step2")
    shutil.copytree(ckdir / "step_000000002", step2 / "step_000000002")
    return jcfg, tcfg, params, params_np, tc, res.losses, step2


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
