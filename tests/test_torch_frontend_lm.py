"""The frontends and the encoder in the port's LM (`repro_torch.models.lm`)
against the JAX reference, at smoke size in float32 on the CPU.

internvl2-1b's vision prefix (`frontend_embeds` projected by
`frontend_proj` and prepended to the text) and seamless-m4t-medium's
bidirectional `enc` stack over `frames` with its `xdec` decoder
(self-attention, cross-attention to the encoder, MLP), on their
`-butterfly-smoke` variants (the sandwich at every MLP, the encoder's
included, and at the head). The port draws the weights, on butterfly
sites with the reference's truncation indices, and the reference gets them
through `convert.to_jax_params`; inputs come from numpy seeds. Held at
1e-5 of each element and of the array's largest magnitude (`_close`):

* the loss against the reference's `loss_fn`, and the logits at every
  position against the reference's full forward;
* the encoder's output over 24 frames (masked) and 64 (blockwise, without
  the causal mask), and the loss over 64;
* a whole-prompt prefill of 1, 5 and 20 text tokens, then three decode
  steps, against the reference's full forward at those positions;
* the gradient of every leaf (atol 1e-5, rtol 1e-4, as the zoo files hold
  them), the encoder's and seamless's unused `frontend_proj` (zeros in
  both) included, and one step of both Trainers moving that unused leaf
  by the same weight decay;
* `convert`'s round trip of `enc_unit[0]`, `frontend_proj` and `enc_norm`
  and of the optimizer state, through a checkpoint either package reads.

Two inputs make the reference's decode disagree with its own full forward,
and the port's engine refuses both (`test_torch_frontend_serve.py`):
frames shorter than `enc_seq` (decode attends to the zero rows that pad the
cross cache) and a vision request without embeddings (decode positions
count a prefix that was never written). Both are shown here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointing import CheckpointManager as JCkpt
from repro.configs import registry as jreg
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import for_model as jfor_model
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.runtime import pytree as pt
from repro.serve import cache as jcache
from repro.train import steps as jsteps
from repro.train.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.checkpoint.checkpointing import CheckpointManager
from repro_torch.configs import registry as treg
from repro_torch.configs.base import TrainConfig
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.serve import cache as tcache
from repro_torch.train import steps as tsteps
from repro_torch.train.trainer import Trainer
from test_torch_lm import reference_site_specs

TOL = 1e-5
ARCHS = ("internvl2-1b-butterfly-smoke", "seamless-m4t-medium-butterfly-smoke")
VISION, AUDIO = ARCHS
SEQ, MAX_LEN = 24, 32
PROMPTS = (1, 5, 20)
DECODES = 3


def _jforward(cfg, params, tokens, frontend_embeds, frames):
    """The reference's full forward: logits at every position, prefix
    included."""
    x = jlm.embed_inputs(cfg, params, tokens, frontend_embeds)
    B, S, _ = x.shape
    positions = jnp.broadcast_to(jnp.arange(S), (B, S))
    enc_out = (jlm.run_encoder(cfg, params, frames) if cfg.n_enc_layers
               else None)
    x, _, _ = jlm.backbone(cfg, params, x, positions=positions,
                           mode="train", enc_out=enc_out)
    x = jcm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return jcm.head_apply(cfg, params["head"], params["embed"], x)


J_FORWARD = jax.jit(_jforward, static_argnums=0)
J_LOSS = jax.jit(jlm.loss_fn, static_argnums=0)
J_GRAD = jax.jit(jax.value_and_grad(jlm.loss_fn, argnums=1, has_aux=True),
                 static_argnums=0)
J_PREFILL = jax.jit(jlm.prefill, static_argnums=0)
J_DECODE = jax.jit(jlm.decode_step, static_argnums=0)
J_ENCODER = jax.jit(jlm.run_encoder, static_argnums=0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under the
    suite's parallel workers the threads only contend: this module runs on
    one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carried(arch, seed=0):
    """(jax cfg, jax params, port cfg, port model) with equal weights, both
    computing in float32; the port draws them."""
    jcfg = jreg.get(arch).with_(compute_dtype="float32")
    tcfg = treg.get(arch).with_(compute_dtype="float32")
    specs = ({k: convert.butterfly_spec_from_jax(s)
              for k, s in reference_site_specs(jcfg).items()}
             if jcfg.butterfly else None)
    model = tlm.LM(tcfg, generator=torch.Generator().manual_seed(seed),
                   site_specs=specs)
    params_np = convert.to_jax_params(dict(model.named_parameters()), tcfg)
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, params_np), tcfg,
            model)


@functools.lru_cache(maxsize=None)
def _carried(arch):
    return carried(arch)


def extras(cfg, batch, seed=1, frames_rows=None):
    """A frontend's inputs as numpy float32: ``frontend_embeds`` for a
    vision config, ``frames`` (``frames_rows`` rows, ``enc_seq`` by
    default) for an encoder one."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "vision":
        out["frontend_embeds"] = rng.normal(
            size=(batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.n_enc_layers:
        out["frames"] = rng.normal(size=(batch, frames_rows or cfg.enc_seq,
                                         cfg.d_model)).astype(np.float32)
    return out


def _close(got, want, tol=TOL):
    """Within ``tol`` of the reference relative to each element and to the
    array's largest magnitude."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def _tforward(model, tokens, ex):
    """The port's full forward, through its own entry points' pieces."""
    cfg = model.cfg
    x = tlm.embed_inputs(model, tokens, ex.get("frontend_embeds"))
    enc_out = (tlm.run_encoder(model, ex["frames"], "torch")
               if cfg.n_enc_layers else None)
    B, S = x.shape[:2]
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    x, _ = tlm.backbone(model, x, positions=pos, context="torch",
                        enc_out=enc_out)
    x = tcm.rmsnorm(x, model.final_norm, cfg.norm_eps)
    return tcm.head_apply(cfg, model.head, x, "torch")


def _n_front(cfg):
    return cfg.frontend_tokens if cfg.frontend == "vision" else 0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_logits_match_reference(arch):
    """The loss on a 2 x 24 batch, and the logits at every position of the
    prefix and the text."""
    jcfg, params, tcfg, model = _carried(arch)
    batch = jfor_model(jcfg, SEQ, 2, seed=0).batch(0)
    batch.update(extras(jcfg, 2))
    loss, metrics = J_LOSS(jcfg, params, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        tloss, tmetrics = tlm.loss_fn(model, tb, "torch")
        logits = _tforward(model, tb["tokens"], tb)
    _close(tloss, loss)
    _close(tmetrics["ce"], metrics["ce"])
    want = J_FORWARD(jcfg, params, jnp.asarray(batch["tokens"]),
                     *(None if k not in batch else jnp.asarray(batch[k])
                       for k in ("frontend_embeds", "frames")))
    assert logits.shape == want.shape == (
        2, _n_front(jcfg) + SEQ, jcfg.vocab_size)
    _close(logits, want)


@pytest.mark.parametrize("rows", [24, 64])
def test_encoder_matches_reference(rows):
    """The encoder's output over 24 frames (the masked path) and over 64
    (from `blockwise_threshold` on: the blockwise path without the causal
    mask), and the loss over 64 frames: training takes frames of any
    length, as the reference's does."""
    jcfg, params, tcfg, model = _carried(AUDIO)
    ex = extras(jcfg, 2, frames_rows=rows)
    want = J_ENCODER(jcfg, params, jnp.asarray(ex["frames"]))
    with torch.no_grad():
        got = tlm.run_encoder(model, torch.from_numpy(ex["frames"]),
                              "torch")
    _close(got, want)
    if rows >= jcfg.blockwise_threshold:
        batch = {**jfor_model(jcfg, 16, 2, seed=1).batch(0), **ex}
        loss, _ = J_LOSS(jcfg, params, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
        with torch.no_grad():
            tloss, _ = tlm.loss_fn(model, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
        _close(tloss, loss)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_reference_forward(arch):
    """A whole-prompt prefill of 1, 5 and 20 text tokens into a fresh dense
    cache (its rows after the prefix, its cross rows from the encoder),
    then three decode steps at positions ``n_front + P ...``, each read
    against the reference's full forward over the same 24 tokens at that
    position (causality makes a prefix's logits its own)."""
    jcfg, params, tcfg, model = _carried(arch)
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (1, SEQ)).astype(np.int32)
    ex = extras(jcfg, 1)
    want = np.asarray(J_FORWARD(jcfg, params, jnp.asarray(tokens),
                                *(None if k not in ex else jnp.asarray(ex[k])
                                  for k in ("frontend_embeds", "frames"))))
    front = _n_front(jcfg)
    tex = {k: torch.from_numpy(v) for k, v in ex.items()}
    for P in PROMPTS:
        caches = tcache.init_caches(tcfg, 1, MAX_LEN, "cpu")
        with torch.no_grad():
            got = tlm.prefill(model, torch.from_numpy(tokens[:, :P]), caches,
                              "torch", **tex)
            _close(got, want[:, front + P - 1])
            for t in range(P, P + DECODES):
                got = tlm.decode_step(model, torch.from_numpy(tokens[:, t]),
                                      caches, torch.tensor([front + t]),
                                      None, "torch")
                _close(got, want[:, front + t])
    if jcfg.n_enc_layers:
        assert float(caches["cross_k"].abs().min(dim=2).values.max()) > 0


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference_leaf_by_leaf(arch):
    """Every leaf's gradient, the encoder's and the frontend projection's
    included; seamless's `frontend_proj` is unused, so both give zeros."""
    jcfg, params, tcfg, model = _carried(arch)
    batch = jfor_model(jcfg, SEQ, 2, seed=0).batch(0)
    batch.update(extras(jcfg, 2))
    (loss, _), grads = J_GRAD(jcfg, params, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
    tloss, tgrads = tsteps.loss_and_grads(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(loss), atol=1e-5,
                               rtol=1e-4)
    port = convert.to_jax_params(tgrads, tcfg)
    leaves = jax.tree_util.tree_leaves_with_path(grads)
    assert len(leaves) == len(convert.names_by_reference_key(tgrads, tcfg))
    keys = [jax.tree_util.keystr(p) for p, _ in leaves]
    assert any("frontend_proj" in k for k in keys)
    for path, want in leaves:
        np.testing.assert_allclose(_leaf(port, path), np.asarray(want),
                                   atol=1e-5, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    unused = jcfg.frontend != "vision"
    assert (float(np.abs(port["frontend_proj"]).max()) == 0.0) == unused
    if jcfg.n_enc_layers:
        assert float(np.abs(port["enc_unit"][0]["ffn"]["up"]["core"]).max()
                     ) > 0


def test_unused_frontend_proj_takes_the_reference_update():
    """One step of both Trainers from the same weights: the loss, and
    seamless's `frontend_proj`, which no path reads, moved by Adam's
    weight decay alone (its gradient zeros) to the reference's value."""
    jcfg, params, tcfg, model = carried(AUDIO)
    before = model.frontend_proj.detach().clone()
    # no warmup: the first step runs at the peak rate
    tc = dict(learning_rate=3e-3, warmup_steps=0, total_steps=20,
              checkpoint_every=0)
    jt = JTrainer(jcfg, JTrainConfig(**tc), seq_len=16, global_batch=2)
    jp = jax.tree_util.tree_map(jnp.array, params)
    batch = jt._make_batch_arrays(jt.data.batch(0))
    jp, _, m = jt.step_fn(jp, jt.tx.init(jp), batch)
    res = Trainer(tcfg, TrainConfig(**tc), seq_len=16, global_batch=2,
                  device="cpu").run(1, model=model)
    np.testing.assert_allclose(res.losses[0], float(m["loss"]), rtol=1e-4)
    got = model.frontend_proj.detach()
    assert not torch.equal(got, before)
    np.testing.assert_allclose(got.numpy(), np.asarray(jp["frontend_proj"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        (got - before).numpy(),
        np.asarray(jp["frontend_proj"]) - before.numpy(), rtol=1e-4,
        atol=3e-8)         # the float32 rounding of weights of ~0.2


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_round_trip(arch, tmp_path):
    """The reference-layout tree into a port model and back unchanged, in
    the structure of the reference's param specs (`frontend_proj`,
    `enc_unit[0]` stacked over the encoder's layers, `enc_norm`); the
    optimizer state after a step through `opt_state_to_jax` and
    `load_jax_opt_state`; and a checkpoint the port writes, restored by the
    reference against its own template."""
    jcfg, params, tcfg, model = _carried(arch)
    want = jax.tree_util.tree_map(np.asarray, params)
    specs = reference_site_specs(jcfg)
    model = convert.from_jax_params(tcfg, want, specs, device="cpu")
    named = dict(model.named_parameters())
    got = convert.to_jax_params(named, tcfg)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(
            jlm.model_specs(jcfg),
            is_leaf=lambda x: isinstance(x, pt.ParamSpec))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w,
                                      err_msg=jax.tree_util.keystr(path))
    assert "frontend_proj" in got
    if jcfg.n_enc_layers:
        assert got["enc_unit"][0]["attn"]["wq"].shape[0] == jcfg.n_enc_layers
        assert got["enc_norm"].shape == (jcfg.d_model,)
    tc = TrainConfig(warmup_steps=1, total_steps=4)
    tx = tsteps.make_optimizer(tc, tcfg)
    state = tx.init(tsteps.trainable(model))
    batch = {k: torch.from_numpy(v) for k, v in
             {**jfor_model(jcfg, 8, 1, seed=0).batch(0),
              **extras(jcfg, 1)}.items()}
    state, _ = tsteps.make_train_step(tcfg, tx)(model, state, batch)
    tree = convert.opt_state_to_jax(state, tcfg)
    back = convert.load_jax_opt_state(tcfg, state, tree)
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(back)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    CheckpointManager(str(tmp_path)).save(
        1, {"params": convert.to_jax_params(dict(model.named_parameters()),
                                            tcfg), "opt": tree})
    jtx = jsteps.make_optimizer(JTrainConfig(warmup_steps=1, total_steps=4))
    tmpl = {"params": params, "opt": jtx.init(params)}
    step, restored, _ = JCkpt(str(tmp_path)).restore(tmpl)
    assert step == 1
    final = convert.to_jax_params(dict(model.named_parameters()), tcfg)
    for (path, r), w in zip(
            jax.tree_util.tree_leaves_with_path(restored["params"]),
            jax.tree_util.tree_leaves(final)):
        np.testing.assert_array_equal(np.asarray(r), w,
                                      err_msg=jax.tree_util.keystr(path))


def _reference_decode_gap(jcfg, params, tokens, ex, cur_pos, full):
    """The reference's own serving path on one request: a whole-prompt
    prefill of ``tokens[:, :-1]`` with ``ex`` into a fresh dense cache,
    then one decode step of the last token at ``cur_pos``, against
    ``full``, the reference's full forward logits at that token. Returns
    (the prefill's gap to ``full`` one position earlier, the decode's gap),
    each the largest absolute difference."""
    P = tokens.shape[1] - 1
    caches = jcache.init_caches(jcfg, 1, MAX_LEN)
    batch = {"tokens": jnp.asarray(tokens[:, :P]),
             **{k: jnp.asarray(v) for k, v in ex.items()}}
    logits, caches = J_PREFILL(jcfg, params, batch, caches)
    dec, _ = J_DECODE(jcfg, params, jnp.asarray(tokens[:, P]), caches,
                      jnp.asarray([cur_pos], jnp.int32))
    return (float(np.abs(np.asarray(logits) - full[:, -2]).max()),
            float(np.abs(np.asarray(dec) - full[:, -1]).max()))


@pytest.mark.parametrize("rows", [None, 16])
def test_reference_decode_after_short_frames_disagrees(rows):
    """Frames of ``enc_seq`` rows: the reference's decode equals its full
    forward. Frames of 16 rows (enc_seq is 24): its prefill pads the cross
    cache with 8 zero rows and its decode attends to them unmasked, so the
    decode step disagrees with the full forward over the same frames,
    while the prefill, which attends to the 16 projected rows alone,
    agrees."""
    jcfg, params, _, _ = _carried(AUDIO)
    tokens = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (1, 9)).astype(np.int32)
    ex = extras(jcfg, 1, frames_rows=rows)
    full = np.asarray(J_FORWARD(jcfg, params, jnp.asarray(tokens), None,
                                jnp.asarray(ex["frames"])))
    pre, dec = _reference_decode_gap(jcfg, params, tokens, ex, 8, full)
    scale = float(np.abs(full).max())
    assert pre <= TOL * scale
    if rows is None:
        assert dec <= TOL * scale
    else:
        assert dec > 1e-2 * scale, (dec, scale)


@pytest.mark.parametrize("embeds", [True, False])
def test_reference_decode_without_embeds_disagrees(embeds):
    """With its 8 patch embeddings, the reference's decode at ``cur_pos =
    frontend_tokens + plen`` (its engine's position) equals its full
    forward. Without them its prefill writes the text at positions
    ``0..plen-1`` while the engine still decodes at ``frontend_tokens +
    plen``: the step reads 8 unwritten zero rows and ropes at a shifted
    position, and disagrees with the full forward over the text alone."""
    jcfg, params, _, _ = _carried(VISION)
    tokens = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (1, 9)).astype(np.int32)
    ex = extras(jcfg, 1) if embeds else {}
    full = np.asarray(J_FORWARD(
        jcfg, params, jnp.asarray(tokens),
        jnp.asarray(ex["frontend_embeds"]) if embeds else None, None))
    cur_pos = jcfg.frontend_tokens + tokens.shape[1] - 1
    pre, dec = _reference_decode_gap(jcfg, params, tokens, ex, cur_pos, full)
    scale = float(np.abs(full).max())
    assert pre <= TOL * scale
    if embeds:
        assert dec <= TOL * scale
    else:
        assert dec > 1e-2 * scale, (dec, scale)
