"""The zoo's paged-servable archs in the port's LM (`repro_torch.models.lm`)
against the JAX reference, at smoke size in float32 on the CPU.

Weights come from the reference's own init and are carried into the port
with `repro_torch.convert.from_jax_params`. For `olmoe-1b-7b-smoke` and its
butterfly variant, `dbrx-132b-smoke`, `gemma-7b-smoke` (tied head, GeGLU)
and its butterfly variant, and `mistral-large-123b-smoke`: prefill-chunk
and decode logits through the paged path on the same page tables, and
`loss_fn`'s loss, ce and aux, at 1e-5 (arrays at 1e-5 of their largest
magnitude as well as of each element: `_close`); a
`seamless-m4t-medium-smoke` MLP block (`gelu_mlp`) at 1e-5. Gradients
leaf by leaf for the OLMoE and Gemma smoke archs at the tolerance
`test_torch_train.py` holds smollm's (atol 1e-5, rtol 1e-4). The param
tree round-trips, a tied head included, the serving entry points compute
no aux loss, and the port's `Trainer` on `olmoe-1b-7b-butterfly-smoke` gives the
reference `Trainer`'s per-step ce and aux (rtol 1e-4, as the 4-step losses
of `test_torch_train.py`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import for_model as jfor_model
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro.runtime import pytree as pt
from repro.serve import cache as jcache
from repro.train.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.configs.base import TrainConfig
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp
from repro_torch.models import moe as tmoe
from repro_torch.serve.cache import PagedCachePool
from repro_torch.train import steps as tsteps
from repro_torch.train.trainer import Trainer
from test_torch_lm import reference_site_specs

TOL = 1e-5
# the reference's entry points, compiled once per config (eager jax costs
# seconds a call at these sizes)
J_PREFILL = jax.jit(jlm.prefill_chunk, static_argnums=0)
J_DECODE = jax.jit(jlm.decode_step, static_argnums=0)
J_LOSS = jax.jit(jlm.loss_fn, static_argnums=0)
J_GRAD = jax.jit(jax.value_and_grad(jlm.loss_fn, argnums=1, has_aux=True),
                 static_argnums=0)
SLOTS, MAX_LEN, PS, C = 2, 48, 16, 16
ARCHS = ("olmoe-1b-7b-smoke", "olmoe-1b-7b-butterfly-smoke",
         "dbrx-132b-smoke", "gemma-7b-smoke", "gemma-7b-butterfly-smoke",
         "mistral-large-123b-smoke")


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
    computing in float32. The port draws the weights (on butterfly sites
    with the reference's truncation indices) and the reference gets them
    through `convert.to_jax_params`: drawing them with the reference's
    init compiles one jax program per leaf."""
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


def _close(got, want, tol=TOL):
    """Within ``tol`` of the reference relative to each element and to the
    largest magnitude of the array: float32 rounding in sums of different
    order scales with the logits' size (to ~30 on the butterfly head), not
    with a small element's."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol * scale,
                               rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_logits_and_loss_match_reference(arch):
    """Two chunks for a 19-token prompt and one short chunk for a 9-token
    one (the MoE sees the pad tails, as the reference's does), then three
    decode steps; the loss on a 2 x 24 batch."""
    jcfg, params, tcfg, model = _carried(arch)
    rng = np.random.default_rng(0)
    table = np.asarray([[1, 2, 3], [6, 4, 5]], np.int32)
    jcaches = jcache.PagedCachePool(jcfg, SLOTS, MAX_LEN,
                                    page_size=PS).init()
    tcaches = PagedCachePool(tcfg, SLOTS, MAX_LEN, page_size=PS,
                             device="cpu").init()
    lens = [19, 9]
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    for lo in (0, C):
        tokens = np.zeros((SLOTS, C), np.int32)
        last = np.zeros((SLOTS,), np.int32)
        for b, p in enumerate(prompts):
            seg = p[lo:lo + C]
            tokens[b, :len(seg)] = seg
            last[b] = max(len(seg) - 1, 0)
        start = np.full((SLOTS,), lo, np.int32)
        jl, jh, jcaches = J_PREFILL(
            jcfg, params, jnp.asarray(tokens), jcaches, jnp.asarray(start),
            jnp.asarray(last), jnp.asarray(table))
        with torch.no_grad():
            tl, th = tlm.prefill_chunk(
                model, torch.as_tensor(tokens), tcaches,
                torch.as_tensor(start), torch.as_tensor(last),
                torch.as_tensor(table))
        _close(tl, jl)
        _close(th, jh)
    _close(tcaches["k"], jcaches["unit"][0]["self"]["k"])

    cur = np.asarray(lens, np.int32)
    tok = np.array(jnp.argmax(jl, axis=-1), np.int32)
    for _ in range(3):
        jlog, jcaches = J_DECODE(
            jcfg, params, jnp.asarray(tok), jcaches, jnp.asarray(cur),
            jnp.asarray(table))
        with torch.no_grad():
            tlog = tlm.decode_step(model, torch.as_tensor(tok), tcaches,
                                   torch.as_tensor(cur),
                                   torch.as_tensor(table))
        _close(tlog, jlog)
        tok = np.array(jnp.argmax(jlog, axis=-1), np.int32)
        cur = cur + 1
    _close(tcaches["v"], jcaches["unit"][0]["self"]["v"])

    batch = jfor_model(jcfg, 24, 2, seed=1).batch(0)
    jloss, jm = J_LOSS(jcfg, params,
                       {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tloss, tm = tlm.loss_fn(model, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    for got, want in ((tloss, jloss), (tm["ce"], jm["ce"]),
                      (tm["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got), float(want), atol=TOL,
                                   rtol=TOL)
    assert (float(tm["aux"]) > 0) == (jcfg.n_experts > 0)


def test_seamless_gelu_mlp_block_matches_reference():
    jcfg = jreg.get("seamless-m4t-medium-smoke").with_(
        compute_dtype="float32")
    tcfg = treg.get("seamless-m4t-medium-smoke").with_(
        compute_dtype="float32")
    assert tcfg.mlp_variant == "gelu_mlp"
    mlp = tmlp.MLP(tcfg, generator=torch.Generator().manual_seed(3))
    assert not hasattr(mlp, "gate")
    params = {site: {"w": jnp.asarray(getattr(mlp, site).w.detach().numpy())}
              for site in ("up", "down")}
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(jmlp.mlp_specs(jcfg))
    x = np.random.default_rng(4).normal(
        size=(2, 5, tcfg.d_model)).astype(np.float32)
    want = jmlp.mlp_apply(jcfg, params, jnp.asarray(x))
    with torch.no_grad():
        got = tmlp.mlp_apply(tcfg, mlp, torch.from_numpy(x))
    _close(got, want)


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


@pytest.mark.parametrize("arch", ["olmoe-1b-7b-smoke", "gemma-7b-smoke"])
def test_gradients_match_reference_leaf_by_leaf(arch):
    jcfg, params, tcfg, model = _carried(arch)
    batch = jfor_model(jcfg, 32, 2, seed=0).batch(0)
    (loss, _), grads = J_GRAD(jcfg, params, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
    tloss, tgrads = tsteps.loss_and_grads(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    model.zero_grad(set_to_none=True)
    np.testing.assert_allclose(float(tloss), float(loss), atol=1e-5,
                               rtol=1e-4)
    port = convert.to_jax_params(tgrads, tcfg)
    leaves = jax.tree_util.tree_leaves_with_path(grads)
    assert len(leaves) == len(convert.names_by_reference_key(tgrads, tcfg))
    if jcfg.n_experts:
        assert any("router" in jax.tree_util.keystr(p) for p, _ in leaves)
    for path, want in leaves:
        np.testing.assert_allclose(_leaf(port, path), np.asarray(want),
                                   atol=1e-5, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b-smoke", "gemma-7b-smoke",
                                  "gemma-7b-butterfly-smoke"])
def test_param_tree_round_trips(arch):
    """The reference-layout tree into a port model and back, unchanged, in
    the structure of the reference's own param specs."""
    jcfg, params, tcfg, _ = _carried(arch)
    want = jax.tree_util.tree_map(np.asarray, params)
    specs = (reference_site_specs(jcfg) if jcfg.butterfly else {})
    model = convert.from_jax_params(tcfg, want, specs, device="cpu")
    got = convert.to_jax_params(dict(model.named_parameters()), tcfg)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(
            jlm.model_specs(jcfg),
            is_leaf=lambda x: isinstance(x, pt.ParamSpec))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w,
                                      err_msg=jax.tree_util.keystr(path))
    if jcfg.tie_embeddings:
        assert want["head"] == {} and got["head"] == {}
        assert not [n for n, _ in model.named_parameters()
                    if n.startswith("head")]
    if jcfg.n_experts:
        assert got["unit"][0]["ffn"]["w_down"].shape == (
            jcfg.n_layers, jcfg.n_experts, jcfg.d_ff, jcfg.d_model)


def test_trainer_ce_and_aux_match_reference():
    """Three steps of both Trainers from the same weights on the same
    SyntheticLM batches: loss, ce and aux per step."""
    jcfg, params, tcfg, model = carried("olmoe-1b-7b-butterfly-smoke")
    tc = dict(learning_rate=3e-3, warmup_steps=2, total_steps=20,
              checkpoint_every=0)
    jt = JTrainer(jcfg, JTrainConfig(**tc), seq_len=16, global_batch=2)
    jp = jax.tree_util.tree_map(jnp.array, params)
    opt_state = jt.tx.init(jp)
    want = []
    for i in range(3):      # the reference Trainer's loop, its metrics kept
        batch = jt._make_batch_arrays(jt.data.batch(i))
        jp, opt_state, m = jt.step_fn(jp, opt_state, batch)
        want.append({k: float(m[k]) for k in ("loss", "ce", "aux")})
    res = Trainer(tcfg, TrainConfig(**tc), seq_len=16, global_batch=2,
                  device="cpu").run(3, model=model)
    assert [m["loss"] for m in res.metrics] == res.losses
    for got, ref in zip(res.metrics, want):
        for key in ("loss", "ce", "aux"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-4,
                                       err_msg=key)
        assert got["aux"] > 0


@pytest.mark.parametrize("arch", ("olmoe-1b-7b-smoke", "gemma-7b-smoke"))
def test_aux_loss_is_computed_for_training_only(arch, monkeypatch):
    """The serving entry points drop the aux loss, so they compute none:
    the router runs without its loss terms and a block without MoE adds
    nothing (0.0, no tensor); `loss_fn` still reports ``aux`` as a 0-d
    tensor, positive with MoE blocks and 0 without."""
    cfg = treg.get(arch).with_(compute_dtype="float32")
    model = tlm.LM(cfg, generator=torch.Generator().manual_seed(0))
    calls = []
    route = tmoe.route

    def recording_route(cfg_, moe, xt, with_aux=True):
        calls.append(with_aux)
        return route(cfg_, moe, xt, with_aux)

    monkeypatch.setattr(tmoe, "route", recording_route)
    tokens = torch.randint(0, cfg.vocab_size, (SLOTS, C),
                           generator=torch.Generator().manual_seed(1))
    caches = PagedCachePool(cfg, SLOTS, MAX_LEN, page_size=PS,
                            device="cpu").init()
    table = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    with torch.no_grad():
        tlm.prefill_chunk(model, tokens, caches,
                          torch.zeros(SLOTS, dtype=torch.int32),
                          torch.full((SLOTS,), C - 1, dtype=torch.int32),
                          table)
        tlm.decode_step(model, tokens[:, -1], caches,
                        torch.full((SLOTS,), C, dtype=torch.int32), table)
        x = torch.zeros(SLOTS, C, cfg.d_model)
        pos = torch.arange(C, dtype=torch.int32).expand(SLOTS, C)
        _, aux = tlm.layer_apply(cfg, model.layers[0], x, positions=pos,
                                 cache=(caches["k"][0], caches["v"][0]),
                                 page_table=table)
        assert aux == 0.0 and not torch.is_tensor(aux)
        assert calls == [False] * len(calls)
        loss, m = tlm.loss_fn(model, {"tokens": tokens, "targets": tokens})
    assert torch.is_tensor(m["aux"]) and m["aux"].shape == ()
    assert (float(m["aux"]) > 0) == (cfg.n_experts > 0)
    assert float(loss) == float(m["ce"] + m["aux"])
    n_moe = cfg.n_layers if cfg.n_experts else 0
    # prefill and decode through every layer, layer 0 alone, then training
    serving = 2 * n_moe + int(n_moe > 0)
    assert calls == [False] * serving + [True] * n_moe
