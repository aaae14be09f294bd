"""The port's MoE layer (`repro_torch.models.moe`) against the JAX
reference's single-device path (`repro.models.moe._moe_apply_local`).

Weights are drawn with numpy from a seed in the shapes and scales of the
reference's `moe_specs` and given to both; the inputs are made with numpy
from a seed too. All in
float32 on the CPU, output and aux at 1e-5, in four cases: a capacity
that drops no token (also against the all-experts oracle
`moe_dense_reference`), a capacity that drops tokens, rows whose router
probabilities tie exactly (duplicated router columns and all-zero rows,
where `jax.lax.top_k` takes the lower expert first), and the gradients of
the router and experts and of the input against `jax.grad`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro_torch.configs import registry as treg
from repro_torch.models import moe as tmoe

ARCH = "olmoe-1b-7b-smoke"
TOL = 1e-5
LEAVES = ("router", "w_gate", "w_up", "w_down")
# the reference, compiled once per config (eager jax costs seconds a call)
J_MOE = jax.jit(jmoe._moe_apply_local, static_argnums=0)
J_DENSE = jax.jit(jmoe.moe_dense_reference, static_argnums=0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under the
    suite's parallel workers the threads only contend: this module runs on
    one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _configs(**kw):
    return (jreg.get(ARCH).with_(compute_dtype="float32", **kw),
            treg.get(ARCH).with_(compute_dtype="float32", **kw))


def _pair(jcfg, tcfg, seed=0, tie=False):
    """The reference's params and the port's MoE holding them."""
    rng = np.random.default_rng(seed)
    params = {name: (rng.normal(size=spec.shape)
                     / np.sqrt(spec.shape[spec.fan_in_dim])).astype(np.float32)
              for name, spec in jmoe.moe_specs(jcfg).items()}
    if tie:   # experts 2j and 2j+1 get the same router column
        r = params["router"].copy()
        r[:, 1::2] = r[:, 0::2]
        params["router"] = r
    moe = tmoe.MoE(tcfg)
    with torch.no_grad():
        for name in LEAVES:
            getattr(moe, name).copy_(torch.tensor(params[name]))
    return params, moe


def _x(cfg, B=2, S=12, seed=1, zero_rows=()):
    x = np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)
    for b, s in zero_rows:
        x[b, s] = 0.0
    return x


def _both(jcfg, tcfg, params, moe, x):
    want, waux = J_MOE(
        jcfg, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    with torch.no_grad():
        got, gaux = tmoe.moe_apply(tcfg, moe, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(float(gaux), float(waux), atol=TOL, rtol=TOL)
    return got


def test_no_drops_matches_reference_and_dense_oracle():
    jcfg, tcfg = _configs(capacity_factor=8.0)
    params, moe = _pair(jcfg, tcfg)
    x = _x(tcfg)
    T = x.shape[0] * x.shape[1]
    assert tmoe.capacity(tcfg, T) >= T           # nothing can drop
    got = _both(jcfg, tcfg, params, moe, x)
    oracle = J_DENSE(
        jcfg, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    with torch.no_grad():
        port_oracle = tmoe.moe_dense_reference(tcfg, moe,
                                               torch.from_numpy(x))
    np.testing.assert_allclose(port_oracle.numpy(), np.asarray(oracle),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("cf,S", [(1.25, 12), (0.5, 7), (0.01, 5)])
def test_dropping_capacity_matches_reference(cf, S):
    """Capacities 7, 1 and the floor of 1: tokens past an expert's slots
    are dropped in the reference's order (the stable rank)."""
    jcfg, tcfg = _configs(capacity_factor=cf)
    params, moe = _pair(jcfg, tcfg, seed=2)
    x = _x(tcfg, S=S, seed=3)
    T = 2 * S
    C = tmoe.capacity(tcfg, T)
    assert C == max(1, int(cf * tcfg.top_k * T / tcfg.n_experts))
    got = _both(jcfg, tcfg, params, moe, x)
    with torch.no_grad():
        dense = tmoe.moe_dense_reference(tcfg, moe, torch.from_numpy(x))
    # some token lost an expert to the capacity
    assert not torch.allclose(got, dense, atol=1e-4)


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_tied_router_probabilities_match_reference(cf):
    """Duplicated router columns tie every token's experts in pairs, and
    all-zero rows tie all experts: the lower index goes first, as
    `jax.lax.top_k` orders them, which decides the drops too."""
    jcfg, tcfg = _configs(capacity_factor=cf)
    params, moe = _pair(jcfg, tcfg, seed=4, tie=True)
    x = _x(tcfg, S=10, seed=5, zero_rows=[(0, 3), (1, 0), (1, 9)])
    with torch.no_grad():
        top_p, top_e, _ = tmoe.route(tcfg, moe,
                                     torch.from_numpy(x).reshape(-1, 64))
    # ties are there: each token's pair, lower index first
    assert bool((top_p[:, 0] == top_p[:, 1]).all())
    assert bool((top_e[:, 0] < top_e[:, 1]).all())
    _both(jcfg, tcfg, params, moe, x)


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_gradients_match_jax_grad(cf):
    jcfg, tcfg = _configs(capacity_factor=cf)
    params, moe = _pair(jcfg, tcfg, seed=6)
    x = _x(tcfg, S=9, seed=7)
    w = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = jmoe._moe_apply_local(jcfg, p, xx)
        return jnp.sum(out * w) + aux

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe_apply(tcfg, moe, xt)
    (out * torch.from_numpy(w)).sum().add(aux).backward()
    for name in LEAVES:
        np.testing.assert_allclose(getattr(moe, name).grad.numpy(),
                                   np.asarray(jg[name]), atol=TOL,
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=TOL,
                               rtol=1e-4)
