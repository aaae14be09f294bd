"""The port's expert-parallel MoE (`repro_torch.models.moe` under an ambient
sharding context) against the reference's `moe_apply` under
`use_sharding(make_mesh(...))` (its `_moe_apply_ep`, through `shard_map`)
on the conftest's 8 simulated devices, on the CPU.

Ranks: one world of 4 gloo ranks (the `(data 2, model 2)` and `(model 4)`
meshes) and one of 8 (`(pod 2, data 2, model 2)`), each spawned once for
the module (`repro_torch.runtime.dist.spawn_ranks`) on a thread beside
the reference's compiles, every case run inside them by
`_torch_mesh_ranks.moe_ep_cases`. The reference runs under `jax.jit`
(eager jax costs seconds a call). The model is `olmoe-1b-7b-smoke` in
float32, its weights and inputs drawn with numpy (weights at scale 0.2,
so that routing spreads) and given to both.

Held: the output and the aux loss at rtol/atol 1e-5, and the gradients
of `sum(c * y) + aux` w.r.t. x, the router and the experts at 1e-4 of
each leaf's max |g|; the ranks' results equal bit for bit; the path taken
(three all-reduces a call on the expert-parallel path: the output, the
aux loss, the gradients; none on the local one) and the data axes kept.
Cases: capacity factors 1.0 (tokens dropped, where the capacity of each
data block decides) and 8.0, chunked by `moe_token_chunk`, a batch that
`data` does not divide (the axis is dropped), an expert count that
`model` does not divide (the local path), the aux loss alone (c = 0: its
router gradient must count once, not once a `model` rank), a `(model 4)`
mesh, and the 8-rank mesh with and without `pod` kept. Also the 4-rank
case at capacity 8 against the port's own single-device `moe_apply` run
block by block (aux: the blocks' mean).
"""

import concurrent.futures
import functools
import threading
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import mesh as jmesh
from repro.models import moe as jmoe
from repro.runtime import sharding as jsh
from repro_torch.configs import registry as treg
from repro_torch.models import moe as tmoe
from repro_torch.runtime import dist as rdist
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

import _torch_mesh_ranks as ranks

ARCH = "olmoe-1b-7b-smoke"
TOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's max |g|
DM = ((2, 2), ("data", "model"))
PDM = ((2, 2, 2), ("pod", "data", "model"))
# id -> (mesh, batch, config fields, scale of c); S = 8 tokens a row
CASES = {
    "dm-cf1": (DM, 4, dict(capacity_factor=1.0), 1.0),
    "dm-cf8": (DM, 4, dict(capacity_factor=8.0), 1.0),
    "dm-chunk8-cf1": (DM, 4, dict(capacity_factor=1.0,
                                  moe_token_chunk=8), 1.0),
    "dm-chunk8-cf8": (DM, 4, dict(capacity_factor=8.0,
                                  moe_token_chunk=8), 1.0),
    "dm-batch3": (DM, 3, dict(capacity_factor=1.0), 1.0),
    "dm-experts7": (DM, 4, dict(capacity_factor=1.0, n_experts=7), 1.0),
    "dm-aux-alone": (DM, 4, dict(capacity_factor=1.0), 0.0),
    "m4-cf1": (((4,), ("model",)), 2, dict(capacity_factor=1.0), 1.0),
    "pdm-cf1": (PDM, 4, dict(capacity_factor=1.0), 1.0),
    "pdm-cf8": (PDM, 4, dict(capacity_factor=8.0), 1.0),
    "pdm-batch2": (PDM, 2, dict(capacity_factor=1.0), 1.0),
    "pdm-chunk4": (PDM, 4, dict(capacity_factor=1.25,
                                moe_token_chunk=4), 1.0),
}
# the data axes the reference keeps, and whether the path is expert-parallel
WANT_PATH = {"dm-batch3": ((), True), "dm-experts7": (None, False),
             "m4-cf1": ((), True), "pdm-batch2": (("data",), True),
             "pdm-cf1": (("data", "pod"), True),
             "pdm-cf8": (("data", "pod"), True),
             "pdm-chunk4": (("data", "pod"), True)}


def _world(case_id) -> int:
    return int(np.prod(CASES[case_id][0][0]))


def _inputs(case_id):
    (shape, axes), batch, kw, c_scale = CASES[case_id]
    cfg = treg.get(ARCH).with_(**kw)
    rng = np.random.default_rng(zlib.crc32(case_id.encode()))
    E, F, X = cfg.d_model, cfg.d_ff, cfg.n_experts
    f32 = np.float32
    params = {"router": 0.2 * rng.normal(size=(E, X)).astype(f32),
              "w_gate": 0.2 * rng.normal(size=(X, E, F)).astype(f32),
              "w_up": 0.2 * rng.normal(size=(X, E, F)).astype(f32),
              "w_down": 0.2 * rng.normal(size=(X, F, E)).astype(f32)}
    x = rng.normal(size=(batch, 8, E)).astype(f32)
    c = (c_scale * rng.normal(size=x.shape)).astype(f32)
    return {"arch": ARCH, "cfg": kw, "params": params, "x": x, "c": c,
            "mesh": shape, "axes": axes}


@functools.lru_cache(maxsize=None)
def _reference_fn(kw_items, shape, axes):
    """The reference's sharded ``moe_apply`` under jit: (``sum(c * y) +
    aux``, (y, aux)) and its gradients w.r.t. the params and x."""
    cfg = jreg.get(ARCH).with_(compute_dtype="float32", **dict(kw_items))
    mesh = jmesh.make_mesh(shape, axes)

    def f(params, x, c):
        with jsh.use_sharding(mesh):
            y, aux = jmoe.moe_apply(cfg, params, x)
        return jnp.sum(c * y) + aux, (y, aux)
    return jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))


def _reference(inputs):
    fn = _reference_fn(tuple(sorted(inputs["cfg"].items())),
                       inputs["mesh"], inputs["axes"])
    (_, (y, aux)), (gp, gx) = fn(inputs["params"], inputs["x"],
                                 inputs["c"])
    return {"y": np.asarray(y), "aux": float(aux),
            "grads": [np.asarray(gx)] + [np.asarray(gp[k])
                                         for k in ranks.MOE_LEAVES]}


@pytest.fixture(scope="module")
def worlds():
    """Every case's inputs, the reference's results and each rank's."""
    inputs = {k: _inputs(k) for k in CASES}

    def spawn():
        out = {}
        for n in (4, 8):
            mine = [k for k in CASES if _world(k) == n]
            got = rdist.spawn_ranks(n, ranks.moe_ep_cases,
                                    [inputs[k] for k in mine],
                                    device="cpu", threads=1)
            out.update({k: [g[i] for g in got] for i, k in enumerate(mine)})
        return out

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks_done = pool.submit(spawn)
        want = {k: _reference(v) for k, v in inputs.items()}
        return inputs, want, ranks_done.result()


def _close_grads(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= GRAD_TOL * scale


@pytest.mark.parametrize("case_id", list(CASES))
def test_ep_matches_reference(worlds, case_id):
    _, want, out = worlds
    per_rank = out[case_id]
    got, want = per_rank[0], want[case_id]
    for other in per_rank[1:]:            # the ranks agree bit for bit
        assert np.array_equal(other["y"], got["y"])
        assert other["aux"] == got["aux"]
        for a, b in zip(other["grads"], got["grads"]):
            assert np.array_equal(a, b)
    np.testing.assert_allclose(got["y"], want["y"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=TOL, atol=TOL)
    _close_grads(got["grads"], want["grads"])
    dp, ep = WANT_PATH.get(case_id, (("data",), True))
    assert got["all_reduces"] == (3 if ep else 0)
    if ep:
        assert got["dp"] == dp


def test_ep_matches_single_device(worlds):
    """The (data 2, model 2) case at capacity 8 against the port's own
    ``moe_apply`` on one device, run on each data block's rows: the
    outputs concatenated, the aux loss the blocks' mean."""
    inputs, _, out = worlds
    case = inputs["dm-cf8"]
    cfg = treg.get(ARCH).with_(compute_dtype="float32", **case["cfg"])
    moe = tmoe.MoE(cfg)
    with torch.no_grad():
        for name in ranks.MOE_LEAVES:
            getattr(moe, name).copy_(torch.from_numpy(case["params"][name]))
    x = torch.tensor(case["x"], requires_grad=True)
    ys, auxs = zip(*(tmoe.moe_apply(cfg, moe, xb) for xb in x.chunk(2)))
    y, aux = torch.cat(ys), torch.stack(auxs).mean()
    loss = (y * torch.from_numpy(case["c"])).sum() + aux
    grads = torch.autograd.grad(
        loss, [x] + [getattr(moe, n) for n in ranks.MOE_LEAVES])
    got = out["dm-cf8"][0]
    np.testing.assert_allclose(got["y"], y.detach().numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got["aux"], float(aux.detach()), rtol=TOL,
                               atol=TOL)
    _close_grads(got["grads"], [g.numpy() for g in grads])
    # the whole batch's aux differs from the blocks' mean: EP is per block
    _, whole = tmoe.moe_apply(cfg, moe, x.detach())
    assert abs(float(whole) - float(aux.detach())) > 10 * TOL


def test_dp_axes_follow_the_reference():
    """Greedy over ``("data", "pod")`` while the batch divides the running
    product; axes of size 1 cut nothing and are left out."""
    class Mesh:
        shape = {"pod": 2, "data": 2, "model": 2}
    assert tmoe.dp_axes(Mesh, 4) == ("data", "pod")
    assert tmoe.dp_axes(Mesh, 2) == ("data",)
    assert tmoe.dp_axes(Mesh, 6) == ("data",)
    assert tmoe.dp_axes(Mesh, 3) == ()
    Mesh.shape = {"data": 1, "model": 4}
    assert tmoe.dp_axes(Mesh, 4) == ()


def test_checkpoint_recompute_keeps_the_mesh():
    """A region that ``torch.utils.checkpoint`` recomputes on another
    thread (the autograd engine's device thread, on a card) runs under
    the ambient sharding context of its forward
    (``runtime.sharding.carry_ctx``, which ``lm.backbone`` wraps around
    each checkpointed layer): without it the recompute would route the
    MoE locally and its saved tensors' shapes would differ."""
    from repro_torch.runtime import sharding as rsh

    class Mesh:
        shape = {"model": 2}
    seen = []

    def look():
        ctx = rsh.active_ctx()
        seen.append(None if ctx is None else ctx.mesh)
    with rsh.use_sharding(Mesh):
        carried = rsh.carry_ctx(look)
    for fn in (look, carried):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    assert seen == [None, Mesh]
    assert rsh.carry_ctx(look) is look        # no context: as it is
