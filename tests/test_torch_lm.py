"""The port's LM (`repro_torch.models.lm`) against the JAX reference.

Weights come from the reference's own init and are carried into the port
with `repro_torch.convert.from_jax_params`; both run the paged decode path
on the same page tables and token inputs (made with numpy), in float32.
Tolerance 1e-4: the two frameworks sum the matmuls in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.serve import cache as jcache
from repro.serve import loader as jloader
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.models import lm as tlm
from repro_torch.serve.cache import PagedCachePool
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

ARCH = "smollm-135m-butterfly-smoke"
TOL = 1e-4
SLOTS, MAX_LEN, PS = 2, 48, 16


def reference_site_specs(cfg):
    """The reference's butterfly specs of the four site keys."""
    bc = cfg.butterfly
    E, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    dims = {"mlp_up": (E, F), "mlp_gate": (E, F), "mlp_down": (F, E),
            "lm_head": (E, V)}
    return {key: jcm.site_butterfly_spec(bc.seed, key, n_in, n_out,
                                         bc.k_factor, bc.use_bias)
            for key, (n_in, n_out) in dims.items()}


def carried_models(seed=0):
    """(jax cfg, jax params, port cfg, port model) with equal weights."""
    jcfg = jreg.get(ARCH).with_(compute_dtype="float32")
    tcfg = treg.get(ARCH).with_(compute_dtype="float32")
    params = jloader.init_params(jcfg, seed=seed)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    model = convert.from_jax_params(tcfg, params_np,
                                    reference_site_specs(jcfg), device="cpu")
    return jcfg, params, tcfg, model


@pytest.fixture(scope="module")
def models():
    return carried_models()


def _tables():
    """Both pools' page tables, slot 1 with a permuted page order."""
    P = MAX_LEN // PS
    table = np.zeros((SLOTS, P), np.int32)
    table[0] = [1, 2, 3]
    table[1] = [6, 4, 5]
    return table


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_prefill_chunk_and_decode_match_reference(models):
    jcfg, params, tcfg, model = models
    rng = np.random.default_rng(0)
    table = _tables()
    jcaches = jcache.PagedCachePool(jcfg, SLOTS, MAX_LEN,
                                    page_size=PS).init()
    tcaches = PagedCachePool(tcfg, SLOTS, MAX_LEN, page_size=PS,
                             device="cpu").init()
    C = 16
    # two chunks for slot 0 (19 tokens), one short chunk for slot 1
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
        # the reference under jax.jit: eager jax costs seconds a call
        jl, jh, jcaches = jax.jit(jlm.prefill_chunk, static_argnums=0)(
            jcfg, params, jnp.asarray(tokens), jcaches, jnp.asarray(start),
            jnp.asarray(last), jnp.asarray(table))
        tl, th = tlm.prefill_chunk(
            model, torch.as_tensor(tokens), tcaches, torch.as_tensor(start),
            torch.as_tensor(last), torch.as_tensor(table))
        _close(tl, jl)
        _close(th, jh)
    _close(tcaches["k"], jcaches["unit"][0]["self"]["k"])
    _close(tcaches["v"], jcaches["unit"][0]["self"]["v"])

    cur = np.asarray(lens, np.int32)
    tok = np.asarray([int(np.argmax(np.asarray(jl)[b])) for b in range(2)],
                     np.int32)
    for _ in range(3):
        jlog, jcaches = jax.jit(jlm.decode_step, static_argnums=0)(
            jcfg, params, jnp.asarray(tok), jcaches, jnp.asarray(cur),
            page_table=jnp.asarray(table))
        tlog = tlm.decode_step(model, torch.as_tensor(tok), tcaches,
                               torch.as_tensor(cur), torch.as_tensor(table))
        _close(tlog, jlog)
        tok = np.array(jnp.argmax(jlog, axis=-1), np.int32)
        cur = cur + 1
    _close(tcaches["k"], jcaches["unit"][0]["self"]["k"])


def test_carried_model_names_follow_reference_tree(models):
    _, params, tcfg, model = models
    names = dict(model.named_parameters())
    assert tuple(names["layers.0.attn.wq"].shape) == tuple(
        params["unit"][0]["attn"]["wq"].shape[1:])
    assert len(model.layers) == tcfg.n_layers
    np.testing.assert_array_equal(
        model.head.idx_in.numpy(),
        np.asarray(reference_site_specs(jreg.get(ARCH))["lm_head"].idx_in))
