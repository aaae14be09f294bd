"""The port's bench launcher (``repro_torch.launch.speed``) against the
reference's ``benchmarks/bench_kernels.py``, ``bench_speed.py`` and
``bench_backward.py``, on the CPU.

The launcher prints every reference row name, with the fused rows skipped
as ``no_cuda`` here; its sizes are the reference benches' and its row
names the names they emit (their timing stubbed out, so nothing is
timed); and the value-and-grad steps that its ``backward/butterfly_*``,
``backward/sandwich_*`` and ``backward/flash_*`` rows time compute the
gradients the reference's ``jax.grad`` computes through
``ops.*(context="jnp")`` and the flash oracle, from the reference's weights
carried across as numpy (rtol = atol = 1e-5 in float32,
``tests/test_kernels_grad.py:28``).
"""

import ast
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import butterfly as jbf
from repro.core import layers as jbl
from repro.kernels import ops, ref as jref
from repro.kernels.sandwich import one_hot_select
from repro_torch.launch import speed

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def test_launcher_prints_every_reference_row_on_cpu(tmp_path):
    out = tmp_path / "rows.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.speed", "--device", "cpu",
         "--ns", "64", "128", "--batch", "4", "--iters", "1", "--out",
         str(out)], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    rows = [ln.split(",", 2) for ln in lines[1:]]
    assert [r[0] for r in rows] == speed.row_names(ns=(64, 128))
    for name, us, derived in rows:
        if "_fused_" in name:
            assert us == ""
            assert derived.startswith("status=skipped;reason=no_cuda")
        else:
            assert float(us) > 0 and "impl=plain" in derived
    saved = json.loads(out.read_text())
    assert saved["device"] == "cpu"
    assert [r["name"] for r in saved["rows"]] == [r[0] for r in rows]


def _reference_names(monkeypatch, module, **kwargs):
    """Row names a reference bench emits, its timing stubbed out."""
    names = []
    monkeypatch.setattr(module, "time_fn", lambda *a, **k: 1.0)
    monkeypatch.setattr(module, "emit",
                        lambda name, *a, **k: names.append(name))
    if hasattr(module, "emit_skipped"):
        monkeypatch.setattr(module, "emit_skipped",
                            lambda name, *a, **k: names.append(name))
    module.run(**kwargs)
    return names


def _loop_sizes(path):
    """The sizes tuple of the first ``for n in (...)`` loop and the rows
    ``B = ...`` of a reference bench's ``run``."""
    tree = ast.parse(open(os.path.join(ROOT, "benchmarks", path)).read())
    run = next(f for f in tree.body
               if isinstance(f, ast.FunctionDef) and f.name == "run")
    loop = next(n for n in ast.walk(run) if isinstance(n, ast.For))
    rows = next(n.value.value for n in ast.walk(run)
                if isinstance(n, ast.Assign) and n.targets[0].id == "B")
    return ast.literal_eval(loop.iter), rows


def test_sizes_and_row_names_are_the_reference_benches(monkeypatch):
    """The reference benches' sizes (``bench_kernels``' and
    ``bench_speed``'s from their source: their jax set-up at n = 4096 costs
    seconds here), and ``bench_backward``'s row names as it emits them at
    small n, its timing stubbed out."""
    monkeypatch.syspath_prepend(ROOT)
    from benchmarks import bench_backward
    assert _loop_sizes("bench_kernels.py") == (speed.KERNEL_NS,
                                               speed.KERNEL_B)
    assert _loop_sizes("bench_speed.py") == (speed.SPEED_NS, speed.SPEED_B)
    assert speed.BACKWARD_NS == bench_backward.NS
    assert (speed.FLASH_HEADS, speed.FLASH_DIM) == (
        bench_backward.FLASH_HEADS, bench_backward.FLASH_DIM)
    assert (speed.row_names(only=("backward",), ns=(64, 128))
            == _reference_names(monkeypatch, bench_backward, ns=(64, 128),
                                batch=2, iters=1))
    assert speed.row_names()[:len(speed.KERNEL_NS)] == [
        f"kernel/butterfly_n{n}" for n in speed.KERNEL_NS]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op", ["butterfly", "sandwich", "flash"])
def test_backward_steps_match_reference_grad(op):
    """The gradients of one ``backward/{op}_*`` step, at a small n, from the
    reference's weights and the same inputs."""
    n, batch = 32, 5
    rng = np.random.default_rng(7)
    if op == "butterfly":
        w = np.asarray(jbf.random_weights(jax.random.PRNGKey(0), n))
        x, c = (rng.standard_normal((batch, n)).astype(np.float32)
                for _ in range(2))
        want = jax.grad(lambda x, w: jnp.vdot(c, ops.butterfly_apply(
            x, w, context="jnp")), argnums=(0, 1))(x, w)
        got = speed.butterfly_step(*map(torch.tensor, (x, w, c)),
                                   "torch")()
    elif op == "sandwich":
        k = max(2, int(math.log2(n)))
        spec = jbl.make_spec(jax.random.PRNGKey(3), n, n, k_in=k, k_out=k,
                             use_bias=False)
        params = {key: np.array(v) for key, v in
                  jbl.init_butterfly_linear(jax.random.PRNGKey(4),
                                            spec).items()}
        x, c = (rng.standard_normal((batch, n)).astype(np.float32)
                for _ in range(2))
        sel_in = one_hot_select(spec.idx_in, n)
        sel_out = one_hot_select(spec.idx_out, n).T
        s = math.sqrt(n / k)
        want = jax.grad(lambda x, b_in, core, b_out: jnp.vdot(
            c, ops.sandwich_apply(x, b_in, sel_in, core, sel_out, b_out,
                                  scale_in=s, scale_out=s, context="jnp")),
            argnums=(0, 1, 2, 3))(x, params["b_in"], params["core"],
                                  params["b_out"])
        idx = [torch.tensor(i, dtype=torch.int32)
               for i in (spec.idx_in, spec.idx_out)]
        got = speed.sandwich_step(
            torch.from_numpy(x), *(torch.from_numpy(params[key])
                                   for key in ("b_in", "core", "b_out")),
            *idx, torch.from_numpy(c), s, "torch")()
    else:
        shape = (1, 2, n, 16)
        q, k, v, c = (rng.standard_normal(shape).astype(np.float32)
                      for _ in range(4))
        want = jax.grad(lambda q, k, v: jnp.vdot(
            c, jref.flash_attention_ref(q, k, v, causal=True)),
            argnums=(0, 1, 2))(q, k, v)
        got = speed.flash_step(*map(torch.from_numpy, (q, k, v, c)),
                               "torch")()
    _close(got, want)
