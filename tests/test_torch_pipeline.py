"""The port's GPipe pipeline (`repro_torch.runtime.pipeline`) against the
reference's (`repro.runtime.pipeline`) on the CPU: the same `(stage 4,
data 2)` mesh, stage function `tanh(x @ w + b)` and sizes as the
reference's `tests/test_pipeline.py` (S, D, B = 4, 16, 8), at 1, 4 and 8
microbatches, on weights and inputs drawn with numpy and given to both.

Ranks: one world of 8 gloo ranks, spawned once for the module on a thread
beside the reference's compiles (`_torch_mesh_ranks.pipeline_cases`);
the reference's `pipeline_apply` under `jax.jit` on the conftest's 8
simulated devices. Each case runs both handovers, `batch_isend_irecv`
(`"p2p"`, what gloo takes on CPU tensors) and the all-gather that stands
in for it where the backend takes no point-to-point operations
(`"gather"`, gloo on CUDA tensors; taken here by overriding
`handover_route`). Held, on every rank: the forward at
1e-5 and the gradients of `sum(y ** 2)` w.r.t. w, b and x at 1e-4
(max |Δ|, the reference test's gates) against the reference's
`pipeline_apply` and the port's `reference_apply`; the shifts a call
takes (T + S - 2 each way). A batch that the microbatches do not divide
raises.
"""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_mesh
from repro.runtime import pipeline as jpipe
from repro_torch.runtime import dist as rdist
from repro_torch.runtime import pipeline as tpipe
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

import _torch_mesh_ranks as ranks

S, D, B = 4, 16, 8
MESH = ((S, 2), ("stage", "data"))
MICROBATCHES = (1, 4, 8)
HANDOVERS = ("p2p", "gather")
CASES = [(T, h) for T in MICROBATCHES for h in HANDOVERS]


def _stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


@functools.lru_cache(maxsize=None)
def _reference_fn(T):
    mesh = make_mesh(*MESH)

    def loss(params, x):
        y = jpipe.pipeline_apply(_stage_fn, params, x, mesh=mesh,
                                 microbatches=T)
        return jnp.sum(y ** 2), y
    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))


def _arrays():
    rng = np.random.default_rng(0)
    return {"w": (rng.normal(size=(S, D, D)) / np.sqrt(D)).astype(np.float32),
            "b": (0.1 * rng.normal(size=(S, D))).astype(np.float32),
            "x": rng.normal(size=(B, D)).astype(np.float32)}


@pytest.fixture(scope="module")
def results():
    """The reference's results a microbatch count, the port's unpipelined
    oracle, and every rank's results a case (the raising case last)."""
    arr = _arrays()
    cases = [dict(mesh=MESH[0], axes=MESH[1], T=T, handover=h, **arr)
             for T, h in CASES]
    cases.append(dict(mesh=MESH[0], axes=MESH[1], T=3, raises=True, **arr))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        done = pool.submit(rdist.spawn_ranks, S * 2, ranks.pipeline_cases,
                           cases, device="cpu", threads=1)
        want = {}
        for T in MICROBATCHES:
            (_, y), (gp, gx) = _reference_fn(T)(
                {"w": arr["w"], "b": arr["b"]}, arr["x"])
            want[T] = {"y": np.asarray(y),
                       "grads": [np.asarray(gp["w"]), np.asarray(gp["b"]),
                                 np.asarray(gx)]}
        params = {k: torch.tensor(arr[k], requires_grad=True)
                  for k in ("w", "b")}
        x = torch.tensor(arr["x"], requires_grad=True)
        y = tpipe.reference_apply(ranks._tanh_stage, params, x)
        grads = torch.autograd.grad((y ** 2).sum(),
                                    [params["w"], params["b"], x])
        oracle = {"y": y.detach().numpy(),
                  "grads": [g.numpy() for g in grads]}
        return want, oracle, done.result()


def _close(got, want, tol):
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) < tol


@pytest.mark.parametrize("T,handover", CASES,
                         ids=[f"T{T}-{h}" for T, h in CASES])
def test_pipeline_matches_reference(results, T, handover):
    want, oracle, per_rank = results
    i = CASES.index((T, handover))
    p2p = CASES.index((T, "p2p"))
    for rank in per_rank:
        got = rank[i]
        assert got["route"] == "p2p"          # the rule: gloo, CPU tensors
        assert got["shifts"] == 2 * (T + S - 2)
        # the all-gather fills the stage group's S activations a shift
        want_bytes = rank[p2p]["shift_bytes"] * (S if handover == "gather"
                                                 else 1)
        assert got["shift_bytes"] == want_bytes
        for ref in (want[T], oracle):
            _close(got["y"], ref["y"], 1e-5)
            for a, b in zip(got["grads"], ref["grads"]):
                _close(a, b, 1e-4)


def test_pipeline_refuses_indivisible_batch(results):
    for rank in results[2]:
        assert rank[-1]["error"] == (f"the batch ({B}) must be a multiple "
                                     f"of microbatches (3)")


def test_reference_apply_matches_reference():
    """The port's unpipelined oracle against the reference's."""
    arr = _arrays()
    want = jpipe.reference_apply(
        _stage_fn, {"w": jnp.asarray(arr["w"]), "b": jnp.asarray(arr["b"])},
        jnp.asarray(arr["x"]))
    got = tpipe.reference_apply(
        ranks._tanh_stage, {k: torch.from_numpy(arr[k]) for k in ("w", "b")},
        torch.from_numpy(arr["x"]))
    _close(got.numpy(), np.asarray(want), 1e-5)
