"""The port's sharded butterfly sites against the reference's
(`repro.runtime.butterfly_sharding`), on the CPU.

Ranks: one world of 2 gloo ranks (the `(2,)` mesh) and one of 4 (the
`(4,)` and `(2, 2)` meshes), each spawned once for the module
(`repro_torch.runtime.dist.spawn_ranks`), every case run inside them by
`_torch_mesh_ranks.sharded_cases`. The reference runs the same inputs
through its `shard_map` wrappers with `backend="jnp"` on the same mesh
shape over the conftest's simulated devices, under `jax.jit` (eager jax
costs seconds a call). Held: forward and every gradient at rtol/atol
1e-5, the reference's gate (`tests/test_sharding_butterfly.py`); the
ranks' outputs equal bit for bit; batches of 1, 3, 5, 7 and 8 rows, so
that 2 and 4 shards pad. The encoder–decoder's loss and gradients sum
over the data and keep the reference test's atol (1e-3, 1e-4).
Also the execution context's mesh resolution in the ranks' worlds.
"""

import concurrent.futures
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import encdec as jencdec
from repro.core import layers as jlayers
from repro.kernels import ops as jops
from repro.kernels.context import ExecutionContext as JContext
from repro.kernels.sandwich import one_hot_select
from repro import nn as jnn
from repro_torch import convert
from repro_torch.runtime import dist as rdist
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

import _torch_mesh_ranks as ranks

N = 32                 # butterfly width
SCALES = (1.5, 0.5)    # the sandwich's scale_in, scale_out
# (mesh, kind, batch, transpose): every batch of 1..8 on (2,), each kind
# on each mesh
CASES = [((2,), "butterfly", 1, False), ((2,), "butterfly", 3, True),
         ((2,), "butterfly", 5, False), ((2,), "butterfly", 7, True),
         ((2,), "butterfly", 8, False), ((2,), "butterfly", (3, 5), False),
         ((2,), "sandwich", 3, False), ((2,), "sandwich", 8, False),
         ((2,), "linear", 5, False), ((2,), "linear", 7, False),
         ((2,), "nn", 11, False), ((2,), "encdec", 22, False),
         ((4,), "butterfly", 1, True), ((4,), "butterfly", 5, False),
         ((4,), "sandwich", 7, False), ((4,), "linear", 3, False),
         ((4,), "linear", 8, False),
         ((2, 2), "butterfly", 7, False), ((2, 2), "butterfly", 8, True),
         ((2, 2), "sandwich", 5, False), ((2, 2), "linear", 1, False)]


def _id(case):
    mesh, kind, batch, transpose = case
    rows = "x".join(map(str, batch)) if isinstance(batch, tuple) else batch
    return (f"{'x'.join(map(str, mesh))}-{kind}-{rows}"
            + ("-T" if transpose else ""))


@functools.lru_cache(maxsize=None)
def _specs():
    """The reference's specs and weights of the sandwich, linear, nn and
    encoder–decoder cases, as host arrays."""
    s_spec = jlayers.make_spec(jax.random.PRNGKey(7), 32, 64, k_in=8,
                               k_out=6, use_bias=False)
    s_par = jlayers.init_butterfly_linear(jax.random.PRNGKey(8), s_spec)
    l_spec = jlayers.make_spec(jax.random.PRNGKey(11), 48, 80,
                               use_bias=True)
    l_par = jlayers.init_butterfly_linear(jax.random.PRNGKey(12), l_spec)
    l_par["bias"] = 0.1 * jax.random.normal(jax.random.PRNGKey(13), (80,))
    layer = jnn.ButterflyLinear.create(jax.random.PRNGKey(30), 48, 80,
                                       use_bias=True)
    n_par = layer.init(jax.random.PRNGKey(31))
    e_spec = jencdec.make_spec(jax.random.PRNGKey(18), n=50, d=22, k=4)
    e_par = jencdec.init_params(jax.random.PRNGKey(19), e_spec)
    host = functools.partial(jax.tree_util.tree_map, np.asarray)
    return {"sandwich": (s_spec, host(s_par)), "linear": (l_spec,
                                                          host(l_par)),
            "nn": (layer, host(n_par)), "encdec": (e_spec, host(e_par))}


def _inputs(case):
    """The case's inputs as numpy, from a seed of its own; what a rank
    needs, with the port's specs."""
    mesh, kind, batch, transpose = case
    rng = np.random.default_rng(zlib.crc32(_id(case).encode()))
    lead = batch if isinstance(batch, tuple) else (batch,)
    f32 = np.float32
    out = {"mesh": mesh, "kind": kind, "transpose": transpose}
    if kind == "butterfly":
        out.update(w=rng.normal(size=(5, 2, N)).astype(f32),
                   x=rng.normal(size=lead + (N,)).astype(f32),
                   c=rng.normal(size=lead + (N,)).astype(f32))
    elif kind == "encdec":
        spec, par = _specs()["encdec"]
        port_spec, _ = convert.encdec_from_jax(spec, par, device="cpu")
        out.update(spec=port_spec, params=par,
                   X=rng.normal(size=(50, 22)).astype(f32))
    else:
        spec, par = _specs()[kind]
        spec = spec.spec if kind == "nn" else spec
        n_in, n_out = spec.n_in, spec.n_out
        out.update(spec=convert.butterfly_spec_from_jax(spec),
                   x=rng.normal(size=lead + (n_in,)).astype(f32),
                   c=rng.normal(size=lead + (n_out,)).astype(f32))
        if kind == "sandwich":
            out.update(b_in=par["b_in"], core=par["core"],
                       b_out=par["b_out"], scale_in=SCALES[0],
                       scale_out=SCALES[1])
        else:
            out.update(params=par)
    return out


@functools.lru_cache(maxsize=None)
def _reference_fn(kind, mesh, transpose):
    """The reference's sharded call of ``kind`` on ``mesh`` under jit:
    (output, gradients of sum(c * y)) from the case's arrays."""
    ctx = JContext(backend="jnp", mesh_shape=mesh)
    if kind == "butterfly":
        def f(x, w, c):
            y = jops.butterfly_apply(x, w, transpose=transpose, context=ctx)
            return jnp.sum(c * y), y
        return jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    if kind == "sandwich":
        spec, _ = _specs()["sandwich"]
        sel_in = one_hot_select(spec.idx_in, spec.pad_in)
        sel_out = one_hot_select(spec.idx_out, spec.pad_out).T

        def f(x, b_in, core, b_out, c):
            y = jops.sandwich_apply(x, b_in, sel_in, core, sel_out, b_out,
                                    scale_in=SCALES[0], scale_out=SCALES[1],
                                    context=ctx)
            return jnp.sum(c * y), y
        return jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                          has_aux=True))
    if kind in ("linear", "nn"):
        spec, _ = _specs()[kind]

        def f(x, params, c):
            y = (spec.apply(params, x, context=ctx) if kind == "nn" else
                 jlayers.butterfly_linear_apply(spec, params, x,
                                                context=ctx))
            return jnp.sum(c * y), y
        return jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    spec, _ = _specs()["encdec"]

    def f(params, X):
        return (jencdec.loss_fn(spec, params, X, X, context=ctx),
                jencdec.apply_B(spec, params["B"], X, context=ctx))
    return jax.jit(jax.value_and_grad(f, has_aux=True))


def _reference(inputs):
    kind, mesh, tr = inputs["kind"], inputs["mesh"], inputs["transpose"]
    fn = _reference_fn(kind, mesh, tr)
    if kind == "butterfly":
        (_, y), grads = fn(inputs["x"], inputs["w"], inputs["c"])
    elif kind == "sandwich":
        (_, y), grads = fn(*(inputs[k] for k in ("x", "b_in", "core",
                                                 "b_out", "c")))
    elif kind in ("linear", "nn"):
        (_, y), (gx, gp) = fn(inputs["x"], inputs["params"], inputs["c"])
        grads = [gx] + [gp[k] for k in sorted(gp)]
    else:
        (loss, y), gp = fn(inputs["params"], inputs["X"])
        return {"y": np.asarray(y), "loss": float(loss),
                "grads": [np.asarray(gp[k]) for k in ("B", "E", "D")]}
    return {"y": np.asarray(y), "grads": [np.asarray(g) for g in grads]}


@pytest.fixture(scope="module")
def worlds():
    """Every case's inputs, the reference's results and each rank's, from
    one 2-rank and one 4-rank world (run on a thread of their own while
    the reference compiles); and each world's resolution checks."""
    inputs = {_id(c): _inputs(c) for c in CASES}

    def spawn():
        out = {}
        for n in (2, 4):
            mine = [c for c in CASES if int(np.prod(c[0])) == n]
            got = rdist.spawn_ranks(n, ranks.cases_and_checks,
                                    [inputs[_id(c)] for c in mine],
                                    device="cpu", threads=1)
            out[n] = ([g[1] for g in got],
                      {_id(c): [g[0][i] for g in got]
                       for i, c in enumerate(mine)})
        return out

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks_done = pool.submit(spawn)
        want = {k: _reference(v) for k, v in inputs.items()}
        return want, ranks_done.result()


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_sharded_site_matches_reference(worlds, case):
    want, out = worlds
    per_rank = out[int(np.prod(case[0]))][1][_id(case)]
    got, want = per_rank[0], want[_id(case)]
    for other in per_rank[1:]:        # the ranks agree bit for bit
        assert np.array_equal(other["y"], got["y"])
        for a, b in zip(other["grads"], got["grads"]):
            assert np.array_equal(a, b)
    assert got["y"].shape == want["y"].shape
    _close(got["y"], want["y"])
    if case[1] == "encdec":
        _close(got["loss"], want["loss"], atol=1e-3)
        for a, b in zip(got["grads"], want["grads"]):
            _close(a, b, atol=1e-4)
        return
    assert len(got["grads"]) == len(want["grads"])
    for a, b in zip(got["grads"], want["grads"]):
        _close(a, b)


@pytest.mark.parametrize("n", [2, 4])
def test_context_resolves_the_mesh(worlds, n):
    """``mesh_shape`` resolves to the cached butterfly mesh and its
    layout; ``local()`` strips it and stays local under the caller's mesh
    block; an ambient sharding context's mesh is reused only at the
    requested shape; ``mesh`` wins over ``mesh_shape``; a mesh larger than
    the world raises naming both ways to get the ranks."""
    checks = worlds[1][n][0]
    for rank, c in enumerate(checks):
        assert c["layout"] == f"data={n}"
        assert c["describe"] == f"backend=auto mesh=data={n}"
        assert c["cached"] and c["reused"] and c["explicit_wins"]
        assert c["local"] == (None, None, None, "")
        assert c["local_stays_local"]
        assert c["ambient_mesh"] == f"data={n}"
        assert "--simulated-devices" in c["too_large"]
        assert "torchrun" in c["too_large"]
        assert f"needs {2 * n} ranks but the world has {n}" in \
            c["too_large"]
        coord = (rank // (n // 2), rank % (n // 2))
        assert c["pod"] == ({"pod": 2, "data": n // 2}, coord, rank,
                            coord[1])
        assert all(c["group_ranks"]) and len(c["group_ranks"]) == n // 2 + 1
        if n == 4:
            assert c["other_shape"] == (True, "pod=2,data=2", True)
