"""Serving and training the frontend and encoder archs in the port against
the JAX reference, at smoke size in float32 on the CPU.

* Greedy tokens of the port's `ServeEngine` equal the reference engine's
  for internvl2-1b-smoke (vision prefix) and seamless-m4t-medium-smoke
  (encoder and `xdec` decoder), on the paged pool (the self-attention
  paged, the cross rows dense beside the pages) and the dense pool, whole
  prompts in one power-of-two bucket, each request's inputs drawn from
  the serving CLI's stream `default_rng([seed, 2])`; a scrubbed pool ends
  with its cross rows zeroed.
* The refusals: incremental admission and `spec_k > 0` at construction
  (whole-prompt archs, as the reference refuses them); at `submit`, frames
  other than `enc_seq` rows, a vision request without embeddings, and an
  input the arch does not read (the reference's decode disagrees with its
  own full forward on the first two: `test_torch_frontend_lm.py`). A
  prefill that raises fails its request's future through the client.
* One step of the port's `Trainer` on internvl2-1b-smoke gives the
  reference `Trainer`'s loss (both add the stub embeddings from
  `default_rng(1234)`).
* The serving CLI through two replicas behind the router and the training
  CLI with two microbatches, on each smoke arch.

Weights are drawn by the port and carried to the reference through
`convert.to_jax_params` (`test_torch_frontend_lm.carried`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.serve import Request, ServeClient, ServeEngine
from repro_torch.serve import steps as tsteps
from repro_torch.serve.trace import stub_extras
from repro_torch.train.trainer import Trainer
from test_torch_frontend_lm import carried

ARCHS = ("internvl2-1b-smoke", "seamless-m4t-medium-smoke")
PROMPTS = (5, 7, 3, 6)          # one bucket of 8
NEW = 6
MAX_LEN = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and under the
    suite's parallel workers the threads only contend: this module runs on
    one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        _MODELS[arch] = carried(arch)
    return _MODELS[arch]


def _requests(cfg, seed=0):
    """The prompts and, from the serving CLI's stream, each one's stub
    inputs."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]
    xrng = np.random.default_rng([seed, 2])
    return [(p, stub_extras(cfg, xrng)) for p in prompts]


def _serve(engine, request_cls, reqs):
    futs = [engine.submit(request_cls(prompt=p, max_new_tokens=NEW,
                                      extras=x)) for p, x in reqs]
    engine.run_until_idle(max_ticks=200)
    return [f.result(timeout=0).tokens for f in futs]


@pytest.mark.parametrize("pool", ["paged", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference_engine(arch, pool):
    jcfg, params, tcfg, model = _models(arch)
    reqs = _requests(tcfg)
    kw = dict(slots=2, max_len=MAX_LEN, pool=pool, seed=0)
    want = _serve(JServeEngine(jcfg, params, **kw), JRequest, reqs)
    eng = ServeEngine(tcfg, model, device="cpu", scrub_freed_slots=True,
                      **kw)
    assert eng.prefill_chunk is None and eng.pool.kind == pool
    got = _serve(eng, Request, reqs)
    assert got == want
    assert all(len(t) == NEW for t in got)
    snap = eng.metrics.snapshot()
    assert snap["prefills"] == len(PROMPTS) and snap["chunk_ticks"] == 0
    if tcfg.n_enc_layers:
        assert eng.caches["cross_k"].shape == (
            tcfg.n_layers, 2, tcfg.enc_seq, tcfg.n_kv_heads, tcfg.head_dim_)
        assert not eng.caches["cross_k"].any()        # scrubbed at exit


@pytest.mark.parametrize("arch", ARCHS)
def test_refusals(arch):
    """Incremental admission and speculation need chunked prefill, which
    these archs never take; a request must carry exactly the inputs its
    arch reads, at their shapes."""
    _, _, tcfg, model = _models(arch)
    for kw, what in ((dict(admission="incremental"), "incremental"),
                     (dict(spec_k=3), "spec_k")):
        with pytest.raises(ValueError, match=what):
            ServeEngine(tcfg, model, slots=2, max_len=MAX_LEN, device="cpu",
                        **kw)
    eng = ServeEngine(tcfg, model, slots=2, max_len=MAX_LEN, device="cpu")
    E = tcfg.d_model
    if tcfg.n_enc_layers:
        bad = [({}, r"needs extras\['frames'\]"),
               ({"frames": np.zeros((1, 16, E))}, r"\(1, 24, 64\)"),
               ({"frames": np.zeros((1, 24, E)),
                 "frontend_embeds": np.zeros((1, 8, E))},
                "takes no 'frontend_embeds'")]
    else:
        bad = [({}, r"needs extras\['frontend_embeds'\]"),
               ({"frontend_embeds": np.zeros((1, 8, E + 1))},
                r"\(1, 8, 64\)"),
               ({"frontend_embeds": np.zeros((1, 8, E)),
                 "frames": np.zeros((1, 24, E))}, "takes no 'frames'")]
    for extras, match in bad:
        with pytest.raises(ValueError, match=match):
            eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=2,
                               extras=extras or None))
    assert eng.queued() == 0


def test_text_arch_refuses_extras():
    _, _, tcfg, model = _models(ARCHS[0])
    cfg = tcfg.with_(frontend="", frontend_tokens=0, name="text-only")
    eng = ServeEngine(cfg, type(model)(cfg), slots=1, max_len=MAX_LEN,
                      device="cpu")
    with pytest.raises(ValueError, match="takes no 'frontend_embeds'"):
        eng.submit(Request(prompt=[1], extras={
            "frontend_embeds": np.zeros((1, 8, cfg.d_model))}))


def test_a_failing_prefill_fails_its_future(monkeypatch):
    """The client's crash path reaches a request whose whole-prompt
    prefill raises: its future resolves with the error."""
    _, _, tcfg, model = _models(ARCHS[1])

    def broken(*args, **kwargs):
        def step(*a, **k):
            raise RuntimeError("prefill failed")
        return step

    monkeypatch.setattr(tsteps, "make_bucket_prefill_step", broken)
    eng = ServeEngine(tcfg, model, slots=1, max_len=MAX_LEN, device="cpu")
    (p, x), = _requests(tcfg)[:1]
    with ServeClient(eng) as client:
        fut = client.submit(Request(prompt=p, max_new_tokens=2, extras=x))
        with pytest.raises(RuntimeError, match="prefill failed"):
            fut.result(timeout=60)


def test_trainer_step_matches_reference():
    """One step of both Trainers from the same weights on the same batch,
    the stub embeddings included: the loss."""
    jcfg, params, tcfg, model = carried(ARCHS[0])
    tc = dict(learning_rate=3e-3, warmup_steps=0, total_steps=20,
              checkpoint_every=0)
    jt = JTrainer(jcfg, JTrainConfig(**tc), seq_len=16, global_batch=2)
    jp = jax.tree_util.tree_map(jnp.array, params)
    batch = jt._make_batch_arrays(jt.data.batch(0))
    assert batch["frontend_embeds"].shape == (2, 8, 64)
    _, _, m = jt.step_fn(jp, jt.tx.init(jp), batch)
    res = Trainer(tcfg, TrainConfig(**tc), seq_len=16, global_batch=2,
                  device="cpu").run(1, model=model)
    np.testing.assert_allclose(res.losses[0], float(m["loss"]), rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_clis_run_the_smoke_archs(arch, capsys):
    """The serving CLI through two replicas behind the router (each
    request's stub inputs travel with it), and the training CLI with two
    microbatches (the stub inputs split with the tokens)."""
    doc = serve_cli.main(["--device", "cpu", "--arch", arch, "--replicas",
                          "2", "--slots", "2", "--requests", "4",
                          "--max-new", "3", "--max-len", "32",
                          "--max-prompt", "12", "--rate", "50"])
    snap = doc["summary"]
    assert snap["requests_finished"] == 4
    assert sum(p["dispatched"] for p in snap["per_replica"]) == 4
    res = train_cli.main(["--device", "cpu", "--arch", arch, "--steps", "2",
                          "--seq-len", "8", "--global-batch", "2",
                          "--microbatches", "2"])
    assert res.steps_run == 2 and all(np.isfinite(res.losses))
    out = capsys.readouterr().out
    assert "[serve] router: 4 requests over 2 replicas" in out
    assert out.splitlines()[-1].startswith("[train] done: loss ")
