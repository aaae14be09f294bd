"""The recurrent archs in the port's model and serving engine against the
JAX reference, at smoke size in float32 on the CPU: `recurrentgemma-2b`
(a unit of two `rec` blocks and a `local` one, a two-layer `rec` tail) and
`xlstm-125m` (a unit of five `mlstm` blocks and an `slstm`), each plain and
as its butterfly variant.

* `loss_fn` and its gradients leaf by leaf against the reference's (the
  loss at rtol 1e-4, gradients at 1e-5 of a leaf's largest magnitude), on
  sequences past the mLSTM's chunk of 16 (the chunkwise path) and past
  recurrentgemma's window of 16, with remat.
* `init_caches` and `reset_cache_slot` against the reference's
  `init_caches`: every state field of every layer, the xLSTM's stabilizers
  at -1e30 and the sLSTM's normalizer at 1e-6 included.
* Whole-prompt prefill at 3 and 20 tokens: logits and every recurrent
  state against the reference's prefill, then three decode steps against
  the reference's `decode_step` on its own caches.
* Prompts of 1 and 2 tokens: the reference's prefill keeps fewer conv
  history rows than its cache holds (`repro/models/rglru.py:152`,
  `repro/models/xlstm.py:286`; ROADMAP queue 3), so its decode there is
  off; the port's first decode steps are held against the reference's
  full forward over the prompt and its continuation.
* The engine's greedy tokens on the dense pool (exact-length whole-prompt
  admission, two slots reused), prompts of 1, 2, 5 and 20 tokens, equal to
  greedy decoding by the reference's full forward; the recurrent stacks'
  replay leaves the engine's state as it was.
* `convert`: the param tree in the reference's structure, `r_zifo` (H, D,
  4D) and the `rec` tail included, round-trips through a port model.

Weights are drawn by the port and carried to the reference through
`convert.to_jax_params`; the reference's calls run under `jax.jit`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data.pipeline import for_model as jfor_model
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.runtime import pytree as pt
from repro.serve import cache as jcache
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.models import lm as tlm
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import cache as tcache
from repro_torch.train import steps as tsteps
from test_torch_window_lm import forward_logits_at
from test_torch_window_serve import greedy_by_full_forward
from test_torch_zoo_lm import _close

RG, XL = "recurrentgemma-2b-smoke", "xlstm-125m-smoke"
RGB, XLB = "recurrentgemma-2b-butterfly-smoke", "xlstm-125m-butterfly-smoke"
J_PREFILL = jax.jit(jlm.prefill, static_argnums=0)
J_DECODE = jax.jit(jlm.decode_step, static_argnums=0)
J_GRAD = jax.jit(jax.value_and_grad(jlm.loss_fn, argnums=1, has_aux=True),
                 static_argnums=0)
LENGTH = 48                # cache rows and the reference forward's length


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under the
    suite's parallel workers the threads only contend: this module runs on
    one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _site_specs(jcfg):
    """The reference's butterfly specs of the sites ``jcfg`` builds: the
    head, and the MLP's where the arch has an MLP (d_ff > 0)."""
    bc = jcfg.butterfly
    E, F, V = jcfg.d_model, jcfg.d_ff, jcfg.vocab_size
    dims = {"lm_head": (E, V)}
    if F:
        dims.update(mlp_up=(E, F), mlp_gate=(E, F), mlp_down=(F, E))
    return {key: jcm.site_butterfly_spec(bc.seed, key, n_in, n_out,
                                         bc.k_factor, bc.use_bias)
            for key, (n_in, n_out) in dims.items()}


@functools.lru_cache(maxsize=None)
def carried(arch, seed=0):
    """(jax cfg, jax params, port cfg, port model) with equal float32
    weights, the port's drawn and carried over."""
    jcfg = jreg.get(arch).with_(compute_dtype="float32")
    tcfg = treg.get(arch).with_(compute_dtype="float32")
    specs = ({k: convert.butterfly_spec_from_jax(s)
              for k, s in _site_specs(jcfg).items()}
             if jcfg.butterfly else None)
    model = tlm.LM(tcfg, generator=torch.Generator().manual_seed(seed),
                   site_specs=specs)
    params_np = convert.to_jax_params(dict(model.named_parameters()), tcfg)
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, params_np), tcfg,
            model)


def reference_layer_cache(jcfg, caches, layer):
    """The reference cache fields of port layer ``layer`` (batch first)."""
    U, R = len(jcfg.block_unit), jcfg.unit_repeats
    if layer < R * U:
        entry = caches["unit"][layer % U]
        entry = jax.tree_util.tree_map(lambda a: a[layer // U], entry)
    else:
        entry = caches["tail"][layer - R * U]
    (tree,) = entry.values()
    return tree


def hold_states(jcfg, tcfg, jc, tc, tol=1e-5):
    """Every recurrent state field of every layer of the port's caches
    ``tc`` against the reference's ``jc``."""
    index = tlm.cache_index(tcfg)
    for layer, t in enumerate(tlm.layer_types(tcfg)):
        if t not in tlm.STATE_FIELDS:
            continue
        want = reference_layer_cache(jcfg, jc, layer)
        got = tlm.layer_cache(tcfg, tc, layer, index)
        for f in tlm.STATE_FIELDS[t]:
            _close(got[f], np.asarray(want[f]), tol)


def _prompt(vocab, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (2, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch", [RGB, XLB])
def test_loss_and_gradients_match_reference(arch):
    """`loss_fn` on a 2 x 40 batch (three mLSTM chunks of 16, padded; past
    recurrentgemma's window) with remat, and every gradient leaf."""
    jcfg, params, tcfg, model = carried(arch)
    assert tcfg.remat
    batch = jfor_model(jcfg, 40, 2, seed=0).batch(0)
    (loss, jm), grads = J_GRAD(jcfg, params, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
    tloss, tgrads = tsteps.loss_and_grads(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    model.zero_grad(set_to_none=True)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-4)
    port = convert.to_jax_params(tgrads, tcfg)
    leaves = jax.tree_util.tree_leaves_with_path(grads)
    assert len(leaves) == len(convert.names_by_reference_key(tgrads, tcfg))
    for path, want in leaves:
        got = port
        for k in path:
            got = got[k.key if hasattr(k, "key") else k.idx]
        assert np.isfinite(got).all(), jax.tree_util.keystr(path)
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", [RG, XL])
def test_init_and_reset_match_reference_init(arch):
    """Every field of every layer at the reference's init values, on the
    engine's dense pool too; a slot's reset writes them back."""
    jcfg, _, tcfg, _ = carried(arch)
    jc = jcache.init_caches(jcfg, 2, LENGTH)
    tc = tcache.init_caches(tcfg, 2, LENGTH, "cpu")
    hold_states(jcfg, tcfg, jc, tc, 0.0)
    if arch == XL:
        assert torch.all(tc["mlstm_m"] == -1e30)
        assert torch.all(tc["slstm_m"] == -1e30)
        assert torch.all(tc["slstm_n"] == 1e-6)
    pool = tcache.DenseCachePool(tcfg, 2, LENGTH, device="cpu")
    caches = pool.init()
    assert caches.keys() == tc.keys()
    for k, t in caches.items():
        assert torch.equal(t, tc[k]), k
        t.normal_()
    pool.reset_slot(caches, 1)
    for k, t in caches.items():
        assert torch.equal(t[:, 1], tc[k][:, 1]), k
        assert not torch.equal(t[:, 0], tc[k][:, 0]), k


@pytest.mark.parametrize("arch", [RG, XL])
def test_prefill_then_decode_match_reference_decode(arch):
    """Prompts of 3 tokens (within the mLSTM's chunk of 16: the parallel
    form, then the recurrent one for the state) and 20 (past the chunk, so
    the mLSTM pads, and past recurrentgemma's window of 16): prefill
    logits and every recurrent state, then three decode steps' logits and
    states against the reference's own decode. Past the window the
    reference's ring is rolled the wrong way (ROADMAP queue 3,
    `test_torch_window_lm`), so there recurrentgemma's decode is held
    against its full forward."""
    jcfg, params, tcfg, model = carried(arch)
    for S in (3, 20):
        toks = _prompt(jcfg.vocab_size, S + 3, S)
        jc = jcache.init_caches(jcfg, 2, LENGTH)
        jl, jc = J_PREFILL(jcfg, params, {"tokens": jnp.asarray(
            toks[:, :S])}, jc)
        tc = tcache.init_caches(tcfg, 2, LENGTH, "cpu")
        with torch.no_grad():
            tl = tlm.prefill(model, torch.from_numpy(toks[:, :S]), tc)
        _close(tl, jl)
        hold_states(jcfg, tcfg, jc, tc)
        wrapped = "ring_k" in tc and S > tcfg.sliding_window
        for cur in range(S, S + 3):
            with torch.no_grad():
                tl = tlm.decode_step(model, torch.from_numpy(toks[:, cur]),
                                     tc, torch.tensor([cur, cur],
                                                      dtype=torch.int32))
            if wrapped:
                _close(tl, forward_logits_at(jcfg, params, toks, cur,
                                             LENGTH))
                continue
            jl, jc = J_DECODE(jcfg, params, jnp.asarray(toks[:, cur]), jc,
                              jnp.asarray([cur, cur], jnp.int32))
            _close(tl, jl)
            hold_states(jcfg, tcfg, jc, tc)


@pytest.mark.parametrize("arch", [RG, XL])
@pytest.mark.parametrize("S", [1, 2])
def test_short_prompt_decode_matches_reference_forward(arch, S):
    """A prompt shorter than the conv's W-1 = 3 rows of history: the
    reference's own decode is off here (its prefill keeps S rows where the
    cache holds 3; ROADMAP queue 3), so the port's prefill and three decode
    steps are held against the reference's full forward at each
    position."""
    jcfg, params, tcfg, model = carried(arch)
    toks = _prompt(jcfg.vocab_size, S + 3, 100 + S)
    tc = tcache.init_caches(tcfg, 2, LENGTH, "cpu")
    with torch.no_grad():
        tl = tlm.prefill(model, torch.from_numpy(toks[:, :S]), tc)
    _close(tl, forward_logits_at(jcfg, params, toks, S - 1, LENGTH))
    for cur in range(S, S + 3):
        with torch.no_grad():
            tl = tlm.decode_step(model, torch.from_numpy(toks[:, cur]), tc,
                                 torch.tensor(cur, dtype=torch.int32))
        _close(tl, forward_logits_at(jcfg, params, toks, cur, LENGTH))


@pytest.mark.parametrize("arch", [RG, XL])
def test_engine_greedy_tokens_equal_reference_forward(arch):
    """Prompts of 1, 2, 5 and 20 tokens, 6 new tokens each, on two slots
    of the dense pool (the paged request falls back to it): whole prompts
    at their exact lengths, one decode graph, tokens equal to greedy
    decoding by the reference's full forward. A replay of the decode tick
    mid-run (`replay_decode_logits`) leaves the recurrent state and the
    tokens as they were."""
    jcfg, params, tcfg, model = carried(arch)
    prompts = [np.random.default_rng(n).integers(0, jcfg.vocab_size, n)
               .astype(np.int32) for n in (1, 2, 5, 20)]
    want = [greedy_by_full_forward(jcfg, params, p, 6, LENGTH)
            for p in prompts]
    eng = ServeEngine(tcfg, model, slots=2, max_len=32, seed=0,
                      device="cpu", scrub_freed_slots=True)
    assert eng.pool.kind == "dense" and eng.prefill_chunk is None
    assert [eng.bucket_for(n) for n in (1, 2, 5, 20)] == [1, 2, 5, 20]
    futs = [eng.submit(Request(prompt=p, max_new_tokens=6))
            for p in prompts]
    eng.step()
    eng.step()
    before = {k: t.clone() for k, t in eng.caches.items()}
    eng.replay_decode_logits()
    for k in tcache.state_keys(eng.caches):
        assert torch.equal(eng.caches[k], before[k]), k
    eng.run_until_idle(max_ticks=200)
    assert [f.result(timeout=0).tokens for f in futs] == want
    assert eng.compile_stats["compiles"] == 1
    for k, t in eng.caches.items():            # scrubbed: the init values
        assert bool((t == tcache.init_fill(k)).all()), k


@pytest.mark.parametrize("arch", [RGB, XLB])
def test_param_tree_round_trips_in_reference_layout(arch):
    """The tree of a port model has the structure of the reference's own
    specs (the xLSTM's six unit positions over one repeat; recurrentgemma's
    unit of three over one repeat and its two `rec` tail layers) and
    round-trips through a port model built from it."""
    jcfg, params, tcfg, _ = carried(arch)
    want = jax.tree_util.tree_map(np.asarray, params)
    model = convert.from_jax_params(tcfg, want, _site_specs(jcfg),
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
    if arch == XLB:
        assert got["unit"][5]["slstm"]["r_zifo"].shape == (1, 4, 16, 64)
        assert convert.reference_key("layers.5.slstm.r_zifo", tcfg) == \
            "unit[5].slstm.r_zifo"
    else:
        assert got["tail"][1]["rec"]["w_a"].shape == (64, 64)
        assert convert.reference_key("layers.4.rec.lam", tcfg) == \
            "tail[1].rec.lam"
