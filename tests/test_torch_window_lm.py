"""Sliding windows, rings and multi-type units in the port's model
(`repro_torch.models.attention`, `repro_torch.models.lm`,
`repro_torch.convert`) against the JAX reference, at smoke size in float32
on the CPU.

* `_attend_masked` with windows 0, 5 and 16, and `_attend_blockwise` at
  S = 64 (the smoke's `blockwise_threshold`) in its training form (every KV
  block, masked) and its prefill form (the blocks outside the window
  skipped), windows 0, 16 and 24: against the reference's functions at
  2e-5 (the reference's own blockwise-vs-masked test holds 2e-4).
* `attention` in prefill mode on a ring of 16 with prompts of 9, 16, 20,
  30 and 40 tokens (shorter than, as long as and longer than the ring) and
  on a full row: outputs against the reference's `mode="prefill"`, the
  ring against the reference's k/v laid out at ``slot = pos % ring``;
  then in decode mode with a per-slot `cur_pos` crossing the ring's wrap,
  five steps, outputs and caches each step.
* `gemma3-27b-smoke` and `gemma3-27b-butterfly-smoke` (a unit of five
  `local` and one `global` block, a two-layer `local` tail): whole-prompt
  prefill logits at 5, 16, 20, 30 and 64 tokens, then decode steps across
  the window held against the reference's full forward, `loss_fn` at
  S = 64 (the blockwise training path with the window) at the tolerances
  of `test_torch_zoo_lm.py` (1e-5; the loss at rtol 1e-4), and gradients
  leaf by leaf: the plain arch at atol 1e-5, rtol 1e-4; the butterfly arch
  against its float64 gradient as well (both float32 gradients sit at
  float32 rounding from it, past that).
* The counterpart of the reference's
  `test_prefill_decode_matches_full_forward` for gemma3 (2e-3, as there),
  and prompts of 20 and 30 tokens, whose first decode step is held
  against the reference's full forward.

The reference's prefill rolls a wrapped ring the wrong way
(`repro/models/attention.py:322` rolls by ``-start`` where ``slot = pos %
ring`` needs ``+start``), so its decode after a prompt longer than the
window is right only when ``2 * start`` is a multiple of the ring: 24 and
40 tokens on a ring of 16 are, 20 and 30 are not. Decode is therefore
held against the reference's full forward, which has no ring, and its
rings against :func:`fixed_reference_ring`.
* `convert` on a multi-type unit with a tail: the param tree, the
  optimizer state (top-k compression's error buffers grouped per unit
  position) and a checkpoint each package writes and the other restores.

Weights are drawn by the port and carried to the reference through
`convert.to_jax_params(..., cfg)`; the reference's calls run under
`jax.jit`, since eager jax costs seconds a call.
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
from repro.runtime import pytree as pt
from repro.serve import cache as jcache
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.checkpoint import checkpointing as tckpt
from repro_torch.configs import registry as treg
from repro_torch.configs.base import TrainConfig
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.serve import cache as tcache
from repro_torch.train import steps as tsteps
from test_torch_lm import reference_site_specs
from test_torch_zoo_lm import _close

ARCH = "gemma3-27b-smoke"
ARCHS = (ARCH, "gemma3-27b-butterfly-smoke")
J_PREFILL = jax.jit(jlm.prefill, static_argnums=0)
J_LOSS = jax.jit(jlm.loss_fn, static_argnums=0)
J_GRAD = jax.jit(jax.value_and_grad(jlm.loss_fn, argnums=1, has_aux=True),
                 static_argnums=0)


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
    """(jax cfg, jax params, port cfg, port model) with equal weights in
    float32, the port's drawn and carried over with the arch's unit and
    tail layout."""
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


@functools.partial(jax.jit, static_argnums=0)
def j_forward(cfg, params, tokens):
    """The reference's logits over the whole of ``tokens`` (B, S) in its
    training mode, which keeps no cache: ``loss_fn``'s forward."""
    x = jlm.embed_inputs(cfg, params, tokens)
    B, S, _ = x.shape
    positions = jnp.broadcast_to(jnp.arange(S), (B, S))
    x, _, _ = jlm.backbone(cfg, params, x, positions=positions, mode="train")
    x = jcm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return jcm.head_apply(cfg, params["head"], params["embed"], x)


def forward_logits_at(jcfg, params, tokens, pos, length):
    """The reference's full-forward logits at position ``pos`` of
    ``tokens`` (B, > pos), padded to ``length`` so that one trace serves
    every position (causal: later tokens do not reach ``pos``)."""
    padded = np.zeros((tokens.shape[0], length), np.int32)
    padded[:, :pos + 1] = tokens[:, :pos + 1]
    return j_forward(jcfg, params, jnp.asarray(padded))[:, pos]


def ring_layout(row, length):
    """A whole prompt's k or v (B, S, ...) as a ring of ``length`` holds
    it: the last ``length`` positions, position p at slot ``p % length``,
    zeros in the slots no position has reached."""
    row = np.asarray(row)
    ring = np.zeros((row.shape[0], length) + row.shape[2:], row.dtype)
    for p in range(max(0, row.shape[1] - length), row.shape[1]):
        ring[:, p % length] = row[:, p]
    return ring


def fixed_reference_ring(ring, S):
    """The reference's ring (..., length, KV, D on axis -3) after an
    S-token prefill, with its roll undone: it puts position p at slot
    ``(p - 2 * start) % length``, ``start = S - length``; rolled by
    ``2 * start`` p sits at ``p % length``, where decode reads it."""
    ring = np.asarray(ring)
    start = max(0, S - ring.shape[-3])
    return np.roll(ring, 2 * start, axis=-3)


def _qkv(B=2, S=64, KV=2, G=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((B, S, KV, G, D), (B, S, KV, D), (B, S, KV, D)))


@pytest.mark.parametrize("window", [0, 5, 16])
def test_masked_attention_with_window_matches_reference(window):
    q, k, v = _qkv(S=40, seed=1)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    want = jattn._attend_masked(*map(jnp.asarray, (q, k, v, pos, pos)),
                                causal=True, window=window)
    got = tattn._attend_masked(*map(torch.from_numpy, (q, k, v)),
                               torch.from_numpy(pos.copy()),
                               torch.from_numpy(pos.copy()), window)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("window", [0, 16, 24])
@pytest.mark.parametrize("dynamic", [False, True], ids=["train", "prefill"])
def test_blockwise_attention_with_window_matches_reference(window, dynamic):
    """S = 64 in blocks of 16: the prefill form skips the blocks before
    ``qi*16 - window`` and after the diagonal, the training form masks
    them; both equal the reference's form and the masked path."""
    q, k, v = _qkv()
    want = jattn._attend_blockwise(*map(jnp.asarray, (q, k, v)), causal=True,
                                   window=window, block_q=16, block_kv=16,
                                   dynamic_bounds=dynamic)
    got = tattn._attend_blockwise(*map(torch.from_numpy, (q, k, v)),
                                  block_q=16, block_kv=16, window=window,
                                  dynamic_bounds=dynamic)
    _close(got, want, 2e-5)
    pos = torch.arange(64, dtype=torch.int32).expand(2, 64)
    _close(got, tattn._attend_masked(*map(torch.from_numpy, (q, k, v)),
                                     pos, pos, window), 2e-5)


@functools.partial(jax.jit, static_argnums=(0, 4, 5))
def _j_attention(cfg, params, x, positions, mode, window, cache, cur_pos):
    return jattn.attention(cfg, params, x, positions=positions, mode=mode,
                           cache=cache, cur_pos=cur_pos, window=window)


def _attn_pair(seed=0):
    cfg = treg.get(ARCH).with_(compute_dtype="float32")
    jcfg = jreg.get(ARCH).with_(compute_dtype="float32")
    mod = tattn.Attention(cfg, generator=torch.Generator().manual_seed(seed))
    params = {n: jnp.asarray(p.detach().numpy())
              for n, p in mod.named_parameters()}
    return cfg, jcfg, mod, params


@pytest.mark.parametrize("Sq,length,window", [
    (9, 16, 16), (16, 16, 16), (20, 16, 16), (30, 16, 16), (40, 16, 16),
    (20, 48, 0)],
    ids=["ring_short", "ring_full", "ring_wrapped_20", "ring_wrapped_30",
         "ring_wrapped", "full_row"])
def test_prefill_cache_write_matches_reference(Sq, length, window):
    """A whole prompt written into a ring (shorter than, as long as, longer
    than it: the last `ring` positions at ``pos % ring``) or a full row
    (zero tail), and the prompt's attention output. A ring is held against
    the reference's k/v of the whole prompt (its full-row write) laid out
    by :func:`ring_layout`, not against the reference's own ring."""
    cfg, jcfg, mod, params = _attn_pair()
    x = np.random.default_rng(2).normal(
        size=(2, Sq, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (2, Sq)).copy()
    shape = (2, length, cfg.n_kv_heads, cfg.head_dim_)
    jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    want, jnew = _j_attention(jcfg, params, jnp.asarray(x), jnp.asarray(pos),
                              "prefill", window, jc, None)
    cache = (torch.full(shape, 7.0), torch.full(shape, 7.0))  # overwritten
    with torch.no_grad():
        got = tattn.attention(cfg, mod, torch.from_numpy(x),
                              positions=torch.from_numpy(pos), cache=cache,
                              window=window, prefill=True)
    _close(got, want)
    if window > 0:
        row = {t: jnp.zeros((2, Sq) + shape[2:]) for t in ("k", "v")}
        _, jrow = _j_attention(jcfg, params, jnp.asarray(x),
                               jnp.asarray(pos), "prefill", 0, row, None)
        _close(cache[0], fixed_reference_ring(jnew["k"], Sq))
        jnew = {t: ring_layout(jrow[t], length) for t in ("k", "v")}
    _close(cache[0], jnew["k"])
    _close(cache[1], jnew["v"])


@pytest.mark.parametrize("window,length", [(16, 16), (0, 40)],
                         ids=["ring", "full_row"])
def test_dense_decode_with_per_slot_positions_matches_reference(window,
                                                                length):
    """Three slots at positions 13, 15 and 30 of a ring of 16 (or a full
    row) decode five steps: every slot crosses position 16 or a second
    wrap; outputs and caches each step, from random cache contents."""
    cfg, jcfg, mod, params = _attn_pair(seed=1)
    rng = np.random.default_rng(3)
    shape = (3, length, cfg.n_kv_heads, cfg.head_dim_)
    init = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    jc = {"k": jnp.asarray(init[0]), "v": jnp.asarray(init[1])}
    cache = tuple(torch.from_numpy(a.copy()) for a in init)
    cur = np.asarray([13, 15, 30], np.int32)
    for _ in range(5):
        x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
        want, jc = _j_attention(jcfg, params, jnp.asarray(x),
                                jnp.asarray(cur[:, None]), "decode", window,
                                jc, jnp.asarray(cur))
        with torch.no_grad():
            got = tattn.attention(cfg, mod, torch.from_numpy(x),
                                  positions=torch.from_numpy(cur[:, None]),
                                  cache=cache, window=window)
        _close(got, want)
        _close(cache[0], jc["k"])
        _close(cache[1], jc["v"])
        cur = cur + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_loss_match_reference(arch):
    """Whole-prompt prefill at 5, 16, 20, 30 and 64 tokens (64: the
    blockwise prefill with block skipping) into the dense layout at length
    80: logits and caches against the reference's prefill (its rings with
    their roll undone); then four decode steps, each held against the
    reference's full forward at that position; `loss_fn` on a 2 x 64
    batch."""
    jcfg, params, tcfg, model = _carried(arch)
    rng = np.random.default_rng(0)
    for S in (5, 16, 20, 30, 64):
        toks = rng.integers(0, jcfg.vocab_size, (1, S)).astype(np.int32)
        jc = jcache.init_caches(jcfg, 1, 80)
        jl, jc = J_PREFILL(jcfg, params, {"tokens": jnp.asarray(toks)}, jc)
        tc = tcache.init_caches(tcfg, 1, 80, "cpu")
        with torch.no_grad():
            tl = tlm.prefill(model, torch.from_numpy(toks), tc)
        _close(tl, jl)
        _close(tc["ring_k"][0],
               fixed_reference_ring(jc["unit"][0]["self"]["k"][0], S))
        _close(tc["k"][0], jc["unit"][5]["self"]["k"][0])
        _close(tc["ring_v"][6],
               fixed_reference_ring(jc["tail"][1]["self"]["v"], S))
        seq = np.concatenate([toks, np.argmax(tl.numpy(), -1)[:, None]], 1)
        for cur in range(S, S + 4):
            with torch.no_grad():
                tlog = tlm.decode_step(
                    model, torch.from_numpy(seq[:, cur].astype(np.int32)),
                    tc, torch.tensor([cur], dtype=torch.int32))
            _close(tlog, forward_logits_at(jcfg, params, seq, cur, 80))
            seq = np.concatenate([seq, np.argmax(tlog.numpy(), -1)[:, None]],
                                 1)

    batch = jfor_model(jcfg, 64, 2, seed=1).batch(0)
    jloss, jm = J_LOSS(jcfg, params,
                       {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tloss, tm = tlm.loss_fn(model, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-4)


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _grads(arch, S=64):
    """(reference grads tree, port grads in the reference's layout, the
    port's loss, the reference's) of `loss_fn` on a 2 x S batch."""
    jcfg, params, tcfg, model = _carried(arch)
    batch = jfor_model(jcfg, S, 2, seed=0).batch(0)
    (loss, _), grads = J_GRAD(jcfg, params, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
    tloss, tgrads = tsteps.loss_and_grads(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    model.zero_grad(set_to_none=True)
    assert len(jax.tree_util.tree_leaves(grads)) == \
        len(convert.names_by_reference_key(tgrads, tcfg))
    return grads, convert.to_jax_params(tgrads, tcfg), tloss, loss, batch


def test_gradients_match_reference_leaf_by_leaf():
    """`loss_fn`'s gradients at S = 64 (blockwise training attention with
    the window), every leaf of every unit position and tail layer."""
    grads, port, tloss, loss, _ = _grads(ARCH)
    np.testing.assert_allclose(float(tloss), float(loss), atol=1e-5,
                               rtol=1e-4)
    assert len(port["unit"]) == 6 and len(port["tail"]) == 2
    for path, want in jax.tree_util.tree_leaves_with_path(grads):
        np.testing.assert_allclose(_leaf(port, path), np.asarray(want),
                                   atol=1e-5, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


def test_butterfly_gradients_match_reference_to_float32_rounding():
    """`gemma3-27b-butterfly-smoke` at S = 64. Through eight layers of
    sandwiches both float32 gradients lie up to 1.8e-5 of a leaf's largest
    magnitude from the float64 gradient (the port's own, float64 end to
    end; ~4e-5 on the embedding's leaf of magnitude ~5), and as far from
    each other: past the elementwise 1e-5 / 1e-4 the plain arch holds. So
    each leaf, the port's and the reference's alike, is held within 2e-5
    of its largest magnitude of the float64 gradient and of each other,
    and the port's worst leaf may be no more than 1.5 times as far from
    float64 as the reference's worst."""
    arch = "gemma3-27b-butterfly-smoke"
    grads, port, tloss, loss, batch = _grads(arch)
    np.testing.assert_allclose(float(tloss), float(loss), atol=1e-5,
                               rtol=1e-4)
    _, _, tcfg, model = _carried(arch)
    m64 = tlm.LM(tcfg)
    m64.load_state_dict(model.state_dict())
    m64 = m64.double()
    m64.cfg = tcfg.with_(compute_dtype="float64", param_dtype="float64")
    _, g64 = tsteps.loss_and_grads(
        m64, {k: torch.from_numpy(v) for k, v in batch.items()})
    exact = convert.to_jax_params(g64, tcfg)
    worst = {"port": 0.0, "reference": 0.0}
    for path, want in jax.tree_util.tree_leaves_with_path(grads):
        key = jax.tree_util.keystr(path)
        truth = _leaf(exact, path)
        scale = max(1.0, float(np.abs(truth).max()))
        got = {"port": _leaf(port, path), "reference": np.asarray(want)}
        for who, g in got.items():
            np.testing.assert_allclose(g, truth, rtol=1e-4,
                                       atol=2e-5 * scale,
                                       err_msg=f"{who} {key}")
            worst[who] = max(worst[who],
                             float(np.abs(g - truth).max()) / scale)
        np.testing.assert_allclose(got["port"], got["reference"], rtol=1e-4,
                                   atol=2e-5 * scale, err_msg=key)
    assert worst["port"] <= 1.5 * worst["reference"], worst


def test_prefill_decode_matches_full_forward():
    """The reference's `test_prefill_decode_matches_full_forward` for
    gemma3 on the port: prefill 24 tokens (past the 16-token window), then
    decode token 24; its logits equal the full forward's over 25 tokens."""
    _, _, cfg, model = _carried(ARCH)
    B, S = 2, 24
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
    with torch.no_grad():
        x = tcm.embed(cfg, model.embed, toks)
        pos = torch.arange(S + 1, dtype=torch.int32).expand(B, S + 1)
        x, _ = tlm.backbone(model, x, positions=pos)
        x = tcm.rmsnorm(x, model.final_norm, cfg.norm_eps)
        want = tcm.head_apply(cfg, model.head, x)[:, S]
        caches = tcache.init_caches(cfg, B, S + 1, "cpu")
        tlm.prefill(model, toks[:, :S], caches)
        got = tlm.decode_step(model, toks[:, S], caches,
                              torch.tensor(S, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("S", [20, 30])
def test_wrapped_prefill_then_decode_matches_reference_forward(S):
    """Prompts of 20 and 30 tokens on gemma3's ring of 16, where the
    reference's own prefill-then-decode is off (its ring is rolled the
    wrong way): the port's first decode step after the whole-prompt
    prefill equals the reference's full forward at that position, on two
    rows, at the 1e-5 of the other logits checks."""
    jcfg, params, cfg, model = _carried(ARCH)
    B = 2
    toks = np.random.default_rng(S).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    caches = tcache.init_caches(cfg, B, S + 1, "cpu")
    assert caches["ring_k"].shape[2] == 16
    with torch.no_grad():
        tlm.prefill(model, torch.from_numpy(toks[:, :S]), caches)
        got = tlm.decode_step(model, torch.from_numpy(toks[:, S]), caches,
                              torch.tensor(S, dtype=torch.int32))
    _close(got, forward_logits_at(jcfg, params, toks, S, 80))


def test_param_tree_and_layer_keys_match_reference_layout():
    """The tree round-trips through a port model in the structure of the
    reference's own specs (six unit positions stacked over one repeat,
    two tail layers); each port layer names its reference entry."""
    jcfg, params, tcfg, _ = _carried("gemma3-27b-butterfly-smoke")
    want = jax.tree_util.tree_map(np.asarray, params)
    model = convert.from_jax_params(tcfg, want, reference_site_specs(jcfg),
                                    device="cpu")
    got = convert.to_jax_params(dict(model.named_parameters()), tcfg)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(
            jlm.model_specs(jcfg),
            is_leaf=lambda x: isinstance(x, pt.ParamSpec))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w,
                                      err_msg=jax.tree_util.keystr(path))
    assert [convert.layer_key(tcfg, i) for i in range(8)] == \
        [f"unit[{i}]" for i in range(6)] + ["tail[0]", "tail[1]"]
    assert convert.reference_key("layers.7.attn.wq", tcfg) == \
        "tail[1].attn.wq"
    assert tlm.layer_types(tcfg) == tuple(jcfg.block_unit) + \
        tuple(jcfg.tail_layers)
    full = treg.get("gemma3-27b")
    assert convert.layer_key(full, 61) == "tail[1]"
    assert convert.layer_key(full, 59) == "unit[5]"


def test_optimizer_state_and_checkpoints_cross_packages(tmp_path):
    """Adam with top-k compression after one update: the port's state in
    the reference's layout has the reference optimizer's structure (error
    buffers per unit position and tail layer); a checkpoint the port
    writes restores in the reference, and one the reference writes
    restores in the port, params and state alike."""
    jcfg, params, tcfg, model = _carried(ARCH)
    tc = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10,
              grad_compression="topk", grad_compression_ratio=0.1)
    tx = tsteps.make_optimizer(TrainConfig(**tc), tcfg)
    named = tsteps.trainable(model)
    state = tx.init(named)
    grads = {n: torch.randn_like(p) for n, p in named.items()}
    _, state = tx.update(grads, state, named)
    host = convert.opt_state_to_jax(state, tcfg)
    jstate = jsteps.make_optimizer(JTrainConfig(**tc)).init(params)
    def paths(tree):       # the namedtuple classes differ by package
        return [jax.tree_util.keystr(p)
                for p, _ in jax.tree_util.tree_leaves_with_path(tree)]
    assert paths(host) == paths(jstate)
    assert [type(x).__name__ for x in host] == \
        [type(x).__name__ for x in jstate]
    err = host[1].error
    assert len(err["unit"]) == 6 and len(err["tail"]) == 2
    back = convert.load_jax_opt_state(tcfg, state, host)
    a, b = (tckpt._flatten(tckpt._to_host(s)) for s in (state, back))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    tree = {"params": convert.to_jax_params(named, tcfg), "opt": host}
    tckpt.CheckpointManager(str(tmp_path / "port")).save(3, tree)
    jtmpl = {"params": params, "opt": jstate}
    step, jtree, _ = jckpt.load_latest(str(tmp_path / "port"), jtmpl)
    assert step == 3
    for (p, got), want in zip(jax.tree_util.tree_leaves_with_path(jtree),
                              jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=jax.tree_util.keystr(p))

    jckpt.CheckpointManager(str(tmp_path / "ref")).save(5, jtree)
    step, ttree, _ = tckpt.load_latest(str(tmp_path / "ref"), tree)
    assert step == 5
    fresh = tlm.LM(tcfg, generator=torch.Generator().manual_seed(9))
    convert.load_jax_params(fresh, ttree["params"])
    for (n, p), q in zip(fresh.named_parameters(), named.values()):
        assert torch.equal(p, q), n
    again = convert.load_jax_opt_state(tcfg, state, ttree["opt"])
    c = tckpt._flatten(tckpt._to_host(again))
    for k in a:
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)
