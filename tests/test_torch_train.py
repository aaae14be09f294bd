"""The port's training path against the JAX reference, on
`smollm-135m-butterfly-smoke` in float32 (`compute_dtype="float32"`).

Weights come from the reference's own init and are carried into the port
with `repro_torch.convert.from_jax_params`; both see the same
`SyntheticLM` batches (the port's pipeline is a byte-identical copy).
Tolerances: step-1 loss and per-leaf gradients at atol 1e-5, rtol 1e-4;
4-step Trainer losses at rtol 1e-4 (the two frameworks sum in different
orders); attention outputs at 1e-5.
"""

import functools

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
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

ARCH = "smollm-135m-butterfly-smoke"
TC = dict(learning_rate=3e-3, warmup_steps=2, total_steps=20,
          checkpoint_every=0)


def _configs():
    return (jreg.get(ARCH).with_(compute_dtype="float32"),
            treg.get(ARCH).with_(compute_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _reference_init(seed):
    """The reference's init of the file's config, drawn once a seed (it
    runs one program a leaf), as host arrays."""
    jcfg, _ = _configs()
    params = pt.init_params(jax.random.PRNGKey(seed), jlm.model_specs(jcfg))
    return jax.tree_util.tree_map(np.asarray, params)


def _reference_params(jcfg, seed=0):
    params_np = _reference_init(seed)
    return jax.tree_util.tree_map(jnp.asarray, params_np), params_np


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads():
    """The reference's loss and gradients, jitted once (eager jax costs
    seconds a call)."""
    jcfg, _ = _configs()
    return jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jcfg, p, b), has_aux=True))


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
    (loss, _), grads = _reference_loss_and_grads()(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
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
def reference_runs(tmp_path_factory):
    """``run(kind)``: the reference Trainer's 4 steps from the reference
    init with gradient compression ``kind`` ("" for none) and a checkpoint
    every 2 steps, run once a kind for the whole file: (losses, the
    checkpoint directory)."""
    jcfg, _ = _configs()
    done = {}

    def run(kind):
        if kind not in done:
            params, _ = _reference_params(jcfg)
            ckdir = tmp_path_factory.mktemp("jax_run")
            tc = dict(TC, checkpoint_every=2, grad_compression=kind)
            trainer = JTrainer(jcfg, JTrainConfig(**tc,
                                                  checkpoint_dir=str(ckdir)),
                               seq_len=32, global_batch=4)
            start = jax.tree_util.tree_map(jnp.array, params)
            res = trainer.run(4, params=start,
                              opt_state=trainer.tx.init(start))
            done[kind] = (res.losses, ckdir)
        return done[kind]

    return run


@pytest.fixture(scope="module")
def reference_run(reference_runs):
    """The reference Trainer: 4 steps from the reference init, a checkpoint
    at step 4."""
    jcfg, tcfg = _configs()
    _, params_np = _reference_params(jcfg)
    losses, ckdir = reference_runs("")
    return jcfg, tcfg, params_np, losses, str(ckdir)


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
def test_trainer_with_compression_matches_reference_over_4_steps(
        kind, reference_runs):
    """Gradient compression before Adam: the port's Trainer against the
    reference's over 4 steps, at the 4-step test's tolerance."""
    jcfg, tcfg = _configs()
    _, params_np = _reference_params(jcfg)
    want, _ = reference_runs(kind)
    res = Trainer(tcfg, TrainConfig(**TC, grad_compression=kind), seq_len=32,
                  global_batch=4, device="cpu").run(
        4, model=_port_model(tcfg, jcfg, params_np))
    np.testing.assert_allclose(res.losses, want, rtol=1e-4)
