"""The port's ExecutionContext (`repro_torch.kernels.context`) against the
reference's (`repro.kernels.context`), on the CPU.

For each field the port folds (backend, segment, profile) an explicit
``context=`` beats this thread's ambient ``use_execution`` block, which
beats the config layer (``ButterflyConfig`` via
``from_butterfly_config``), which beats ``REPRO_KERNEL_BACKEND`` (read once
per process); the resolved segment is the reference's on the same layers.
Also: nested blocks merge field by field, resolution is idempotent and
hashable, ``coerce`` takes backend strings, ``backend=`` is a
``TypeError`` at every entry point, ``mesh_shape`` resolved to its mesh
(a mesh larger than the world raising) and refused by the serving engine,
a ``block_b`` the kernel does not take refused by the tile rule at the
call, each naming its ROADMAP item, a finalized context refolded under
another block (keeping its backend and its mesh), the stack is per thread, the profile gate's order, the
butterfly backward's one segment (another refused, naming item 7), and an
engine frozen against an ambient block entered after construction.
"""

import threading

import pytest
import torch

from repro.configs.base import ButterflyConfig as JButterflyConfig
from repro.kernels import context as jctx
from repro_torch.configs.base import ButterflyConfig, TrainConfig
from repro_torch.kernels import butterfly as kb
from repro_torch.kernels import context as exctx
from repro_torch.kernels import flash as kf
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import sandwich as ks
from repro_torch.kernels.context import ExecutionContext, use_execution
from test_torch_chip_smoke import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh_backend_cache():
    """Every test sees (and leaves behind) an unread env-backend cache."""
    exctx.clear_backend_cache()
    jctx.clear_backend_cache()
    yield
    exctx.clear_backend_cache()
    jctx.clear_backend_cache()


# ---------------------------------------------------------------------------
# Precedence: explicit > ambient > config > env, per field
# ---------------------------------------------------------------------------

# (field, explicit, ambient, config kwargs, env value, getter, want)
CASES = [
    ("backend", ExecutionContext(backend="torch"),
     ExecutionContext(backend="cuda"), dict(backend="torch"), "cuda",
     lambda c: c.backend, ["torch", "cuda", "torch", "cuda"]),
    ("segment", ExecutionContext(segment=4), ExecutionContext(segment=3),
     dict(segment=2), None, lambda c: c.segment, [4, 3, 2, None]),
    ("profile", ExecutionContext(profile=True),
     ExecutionContext(profile=False), {}, None, lambda c: c.profile,
     [True, False, None, None]),
]


@pytest.mark.parametrize("field,explicit,ambient,cfg_kw,env,get,want",
                         CASES, ids=[c[0] for c in CASES])
def test_each_layer_beats_the_next(monkeypatch, field, explicit, ambient,
                                   cfg_kw, env, get, want):
    if env is not None:
        monkeypatch.setenv("REPRO_KERNEL_BACKEND", env)
        exctx.clear_backend_cache()
    default = ExecutionContext.from_butterfly_config(ButterflyConfig(
        **cfg_kw))
    with use_execution(ambient):
        assert get(exctx.resolve_execution(explicit, default=default)) \
            == want[0]
        assert get(exctx.resolve_execution(None, default=default)) == want[1]
    assert get(exctx.resolve_execution(None, default=default)) == want[2]
    assert get(exctx.resolve_execution(None)) == want[3]


def test_segment_resolves_as_the_reference_does():
    """The same layers of segments through both packages' resolvers."""
    layers = [(ExecutionContext(segment=4), jctx.ExecutionContext(segment=4)),
              (ExecutionContext(segment=3), jctx.ExecutionContext(segment=3)),
              (ExecutionContext(), jctx.ExecutionContext())]
    for explicit in (0, 2):
        for ambient in (1, 2):
            pe, je = layers[explicit]
            pa_, ja = layers[ambient]
            pd = ExecutionContext.from_butterfly_config(
                ButterflyConfig(segment=2))
            jd = jctx.ExecutionContext.from_butterfly_config(
                JButterflyConfig(segment=2))
            with use_execution(pa_), jctx.use_execution(ja):
                got = exctx.resolve_execution(pe, default=pd).segment
                want = jctx.resolve_execution(je, default=jd).segment
            assert got == want, (explicit, ambient)


@pytest.mark.parametrize("field,value,item", [
    ("block_b", 64, "item 7"), ("mesh_shape", (2, 4), "item 6"),
    ("mesh_axes", ("data",), "item 6")])
def test_unported_fields_merge_and_are_refused(field, value, item):
    """block_b and the mesh fields ride the composition like the others.
    Resolution keeps block_b, which the tile rule (item 7) refuses at a call
    whose kernel does not take it, before any work (the butterfly forward
    at n = 64 owns 16 rows a block). A mesh_shape resolves to its mesh
    (ROADMAP item 6a): in this one-rank process a (pod, data) mesh of 8
    raises, naming both ways to get the ranks; mesh_axes alone resolves
    to no mesh, and ``local()`` keeps it as the reference's does. The
    serving engine (item 6b) resolves them as well, at construction:
    it refuses the mesh of 8 there, before any tick, and serves unsharded
    under ``mesh_axes`` alone."""
    ctx = ExecutionContext(**{field: value})

    def call():
        if field == "mesh_shape":
            return exctx.resolve_execution(None)
        if field == "mesh_axes":
            got = exctx.resolve_execution(None)
            assert (got.mesh, got.mesh_axes, got.mesh_layout()) == \
                (None, value, "")
            return _engine()
        assert exctx.resolve_execution(None).block_b == value
        return kb.butterfly_forward(torch.zeros(2, 64), torch.zeros(6, 2, 64))

    with use_execution(ctx):
        assert getattr(exctx.current_execution(), field) == \
            (tuple(value) if isinstance(value, tuple) else value)
        if field == "mesh_shape":
            with pytest.raises(RuntimeError, match="needs 8 ranks") as e:
                call()
            assert "--simulated-devices 8" in str(e.value)
            assert "torchrun" in str(e.value)
        if field == "mesh_shape":
            with pytest.raises(RuntimeError, match="needs 8 ranks.*"
                               "--simulated-devices 8"):
                _engine()
        elif field == "mesh_axes":
            eng = call()
            assert eng.mesh is None and eng.mesh_layout() == ""
            assert eng.context.mesh_axes == value
        else:
            with pytest.raises(ValueError, match=item):
                call()
    if field == "block_b":
        assert exctx.resolve_execution(ctx).block_b == value
        with pytest.raises(ValueError, match=item):
            kb.butterfly_forward(torch.zeros(2, 64), torch.zeros(6, 2, 64),
                                 context=ctx)
    elif field == "mesh_shape":
        with pytest.raises(RuntimeError, match="--simulated-devices 8"):
            exctx.resolve_execution(ctx)
    jlocal = jctx.ExecutionContext(**{field: value}).local()
    assert ctx.local().mesh_shape is None and ctx.local().mesh is None
    assert ctx.local().mesh_axes == jlocal.mesh_axes


def _engine(cfg=None):
    from repro_torch.configs import registry
    from repro_torch.models.lm import LM
    from repro_torch.serve import ServeEngine
    cfg = cfg or registry.get("smollm-135m-butterfly-smoke")
    model = LM(cfg, generator=torch.Generator().manual_seed(0))
    return ServeEngine(cfg, model, slots=1, max_len=32, device="cpu")


@pytest.mark.parametrize("field,value,item", [("block_b", 8, "item 7"),
                                              ("mesh_shape", (8,), "item 6")])
def test_butterfly_config_with_unported_field_is_refused(field, value,
                                                         item):
    """A ButterflyConfig with block_b or mesh_shape constructs (the
    reference's configs do). block_b = 8 resolves, and the tile rule
    refuses it at the first sandwich call (its row kernels own 64 rows
    forward and 32 backward), before any work. mesh_shape = (8,) resolves
    to its mesh (item 6a): in this one-rank process the Trainer raises at
    construction, not mid-step, and a layer at its first call, naming both
    ways to get the ranks; so does the serving engine (item 6b), before
    any tick."""
    from repro_torch.configs import registry
    from repro_torch.models.lm import LM
    from repro_torch.serve import ServeEngine
    from repro_torch.train.trainer import Trainer
    cfg = registry.get("smollm-135m-butterfly-smoke")
    bad = cfg.with_(butterfly=ButterflyConfig(
        sites=cfg.butterfly.sites, **{field: value}))
    if field == "block_b":
        trainer = Trainer(bad, TrainConfig(checkpoint_every=0), seq_len=16,
                          global_batch=2, device="cpu")
        assert trainer.exec_ctx.block_b == value
        with pytest.raises(ValueError, match=item):
            trainer.run(1)
        model = LM(bad, generator=torch.Generator().manual_seed(0))
        ServeEngine(bad, model, slots=1, max_len=32, device="cpu")
        with pytest.raises(ValueError, match=item):
            model.head(torch.zeros(1, bad.d_model))
        return
    too_large = r"butterfly mesh_shape \(8,\) needs 8 ranks but the world " \
        r"has 1; .* --simulated-devices 8 .* torchrun"
    with pytest.raises(RuntimeError, match=too_large):
        Trainer(bad, TrainConfig(checkpoint_every=0), seq_len=16,
                global_batch=2, device="cpu")
    model = LM(bad, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match=too_large):
        ServeEngine(bad, model, slots=1, max_len=32, device="cpu")
    with pytest.raises(RuntimeError, match=too_large):
        model.head(torch.zeros(1, bad.d_model))


# ---------------------------------------------------------------------------
# Composition and finalization
# ---------------------------------------------------------------------------

def test_nested_ambient_blocks_merge_fieldwise():
    with use_execution(ExecutionContext(backend="torch", segment=2)):
        with use_execution(ExecutionContext(segment=3, profile=True)):
            ctx = exctx.current_execution()
            assert ctx.backend == "torch"          # falls through to outer
            assert ctx.segment == 3 and ctx.profile  # inner wins
        assert exctx.current_execution().segment == 2
        assert exctx.current_execution().profile is None
    assert exctx.current_execution() is None


def test_resolution_is_idempotent_and_hashable():
    ctx = exctx.resolve_execution(ExecutionContext(backend="torch",
                                                   segment=3))
    again = exctx.resolve_execution(ctx)
    assert again == ctx and hash(again) == hash(ctx)
    assert ctx.mesh_layout() == ""
    assert {ctx: 1}[again] == 1
    # a finalized context keeps its backend and set fields under any
    # block; with no block open it comes back as it is, default or not
    with use_execution(ExecutionContext(backend="cuda", segment=1)):
        assert exctx.resolve_execution(ctx) is ctx
        filled = exctx.resolve_execution(
            ctx, default=ExecutionContext(profile=True))
        assert (filled.backend, filled.segment, filled.profile) == \
            ("torch", 3, True)
        assert exctx.resolve_execution(filled) is filled
    assert exctx.resolve_execution(
        ctx, default=ExecutionContext(profile=True)) is ctx
    assert ctx.describe() == "backend=torch segment=3"


def test_finalized_context_refolds_under_an_ambient_block():
    """As the reference refolds: an ambient block other than the context
    itself fills a finalized context's unset fields, and its backend stays
    the resolved one ("auto" included). Inside its own block (the Trainer
    steps so) or under no block it comes back as it is; under
    ``frozen_execution`` an outer block is set aside."""
    for backend in ("torch", "auto"):
        ctx = exctx.resolve_execution(backend)
        with use_execution(ExecutionContext(backend="cuda", segment=4,
                                            profile=True)):
            got = exctx.resolve_execution(ctx)
            assert (got.backend, got.segment, got.profile) == \
                (backend, 4, True)
            assert exctx.resolve_execution(got) is got
            with use_execution(ctx):
                assert exctx.resolve_execution(ctx) is not ctx
            with exctx.frozen_execution(ctx):
                assert exctx.current_execution() is ctx
                assert exctx.resolve_execution(ctx) is ctx
            assert exctx.current_execution().segment == 4
        with use_execution(ctx):
            assert exctx.resolve_execution(ctx) is ctx
        assert exctx.resolve_execution(ctx) is ctx
        with use_execution(ExecutionContext(block_b=8)):
            assert exctx.resolve_execution(ctx).block_b == 8
        with use_execution(ExecutionContext(mesh_shape=(2,))):
            # a finalized context keeps its mesh (none): the block's
            # mesh_shape, which this one-rank process could not build,
            # never reaches it
            assert exctx.resolve_execution(ctx).mesh is None
            assert exctx.resolve_execution(ctx).mesh_shape is None


def test_coerce_accepts_backend_strings():
    assert ExecutionContext.coerce("torch") == ExecutionContext(
        backend="torch")
    assert ExecutionContext.coerce(None) is None
    with pytest.raises(TypeError):
        ExecutionContext.coerce(123)
    with pytest.raises(ValueError, match="unknown backend"):
        ExecutionContext(backend="pallas")


def test_from_butterfly_config_lifts_execution_fields():
    bc = ButterflyConfig(backend="cuda", block_b=8, segment=2,
                         mesh_shape=[8])
    ctx = ExecutionContext.from_butterfly_config(bc)
    assert (ctx.backend, ctx.block_b, ctx.segment, ctx.mesh_shape) == \
        ("cuda", 8, 2, (8,))
    assert ExecutionContext.from_butterfly_config(None) == ExecutionContext()
    # the same fields as the reference's context lifts from its config
    jbc = JButterflyConfig(block_b=8, segment=2, mesh_shape=(8,))
    j = jctx.ExecutionContext.from_butterfly_config(jbc)
    assert (j.block_b, j.segment, j.mesh_shape) == \
        (ctx.block_b, ctx.segment, ctx.mesh_shape)
    # every butterfly site of a model carries its config's fields as its
    # default, and a per-call or ambient context overrides them
    from repro_torch.configs import registry
    from repro_torch.models.lm import LM
    cfg = registry.get("smollm-135m-butterfly-smoke")
    cfg = cfg.with_(butterfly=ButterflyConfig(sites=cfg.butterfly.sites,
                                              backend="torch", segment=3))
    model = LM(cfg, generator=torch.Generator().manual_seed(0))
    site = model.layers[0].ffn.up
    assert site.context == ExecutionContext(backend="torch", segment=3)
    assert model.head.context == site.context
    got = exctx.resolve_execution(ExecutionContext(segment=1),
                                  default=site.context)
    assert (got.backend, got.segment) == ("torch", 1)
    with use_execution("cuda"):
        got = exctx.resolve_execution(None, default=site.context)
    assert (got.backend, got.segment) == ("cuda", 3)


def test_backend_env_read_is_cached_per_process(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "torch")
    exctx.clear_backend_cache()
    assert exctx.resolve_backend("auto") == "torch"
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "cuda")
    assert exctx.resolve_backend("auto") == "torch"      # cached
    exctx.clear_backend_cache()
    assert exctx.resolve_backend("auto") == "cuda"
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "auto")
    exctx.clear_backend_cache()
    assert exctx.resolve_backend("auto") == "auto"      # routes by device


def test_concrete_backend_skips_env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "cuda")
    exctx.clear_backend_cache()
    assert exctx.resolve_backend("torch") == "torch"
    with pytest.raises(ValueError):
        exctx.resolve_backend("not_a_backend")


def test_auto_still_routes_by_the_tensor_device():
    ctx = exctx.resolve_execution(None)
    assert ctx.backend == "auto"
    assert exctx.tensor_route(ctx.backend, torch.zeros(1)) == "torch"
    assert exctx.resolve_for_device(None, "cpu").backend == "torch"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        exctx.resolve_for_device("cuda", "cpu")


# ---------------------------------------------------------------------------
# The stack is per thread
# ---------------------------------------------------------------------------

def test_ambient_stack_is_thread_local():
    """A block on one thread neither shows on another nor reroutes its
    kernel calls: the other thread's call still takes its own route."""
    x = torch.randn(3, 8)
    w = torch.randn(3, 2, 8)
    entered, release = threading.Event(), threading.Event()
    seen = {}

    def other():
        with use_execution(ExecutionContext(backend="cuda", segment=1)):
            seen["inside"] = exctx.current_execution()
            entered.set()
            release.wait(10)

    t = threading.Thread(target=other)
    t.start()
    assert entered.wait(10)
    try:
        assert exctx.current_execution() is None
        # the other thread's "cuda" would raise on a CPU tensor here
        kb.butterfly_forward(x, w)
    finally:
        release.set()
        t.join()
    assert seen["inside"].backend == "cuda"


# ---------------------------------------------------------------------------
# The profile gate: explicit, then ambient, then REPRO_PROFILE
# ---------------------------------------------------------------------------

def test_profile_gate_order(monkeypatch):
    from repro_torch.obs.profiling import annotate, profiling_enabled
    on, off = ExecutionContext(profile=True), ExecutionContext(profile=False)
    monkeypatch.setenv("REPRO_PROFILE", "1")
    assert profiling_enabled()                         # the variable
    with use_execution(off):
        assert not profiling_enabled()                 # ambient beats it
        assert profiling_enabled(on)                   # explicit beats both
        assert annotate("x") is annotate("y")
    monkeypatch.delenv("REPRO_PROFILE")
    with use_execution(on):
        assert profiling_enabled()
        assert not profiling_enabled(off)
        assert isinstance(annotate("sandwich_matmul"),
                          torch.profiler.record_function)
    # an unset field falls through to the variable
    assert not profiling_enabled(ExecutionContext(segment=2))


# ---------------------------------------------------------------------------
# backend= is gone from every entry point
# ---------------------------------------------------------------------------

def _entry_points():
    from repro_torch.configs import registry
    from repro_torch.core import encdec
    from repro_torch.core import layers as bl
    from repro_torch.models import lm
    from repro_torch.nn import ButterflyLinear
    from repro_torch.serve import ServeEngine
    from repro_torch.train import steps
    gen = torch.Generator().manual_seed(0)
    x8, w8 = torch.randn(2, 8), torch.randn(3, 2, 8)
    spec = bl.make_spec(gen, 8, 8, k_in=3, k_out=3, use_bias=False)
    layer = ButterflyLinear(spec, generator=gen)
    idx = torch.zeros(3, dtype=torch.int32)
    sw = dict(scale_in=1.0, scale_out=1.0, n_out=8)
    q = torch.randn(1, 1, 4, 8)
    cfg = registry.get("smollm-135m-butterfly-smoke")
    model = lm.LM(cfg, generator=gen)
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.int32),
             "targets": torch.zeros(1, 4, dtype=torch.int32)}
    return {
        "sandwich_forward": lambda **k: ks.sandwich_forward(
            x8, layer.b_in, layer.core, layer.b_out, idx, idx, **sw, **k),
        "sandwich_backward": lambda **k: ks.sandwich_backward(
            x8, layer.b_in, layer.core, layer.b_out, idx, idx, x8, **sw,
            **k),
        "sandwich_factors": lambda **k: ks.sandwich_factors(
            layer.b_in, layer.b_out, idx, idx, n_in=8, n_out=8,
            dtype=torch.float32, **k),
        "sandwich_factors_vjp": lambda **k: ks.sandwich_factors_vjp(
            layer.b_in, layer.b_out, idx, idx, torch.zeros(3, 8),
            torch.zeros(3, 8), dtype=torch.float32, **k),
        "butterfly_forward": lambda **k: kb.butterfly_forward(x8, w8, **k),
        "butterfly_backward": lambda **k: kb.butterfly_backward(
            x8, w8, x8, **k),
        "butterfly_apply": lambda **k: kb.butterfly_apply(x8, w8, **k),
        "flash_forward": lambda **k: kf.flash_forward(q, q, q, **k),
        "flash_attention": lambda **k: kf.flash_attention(q, q, q, **k),
        "paged_decode_attention": lambda **k: pa.paged_decode_attention(
            torch.zeros(1, 1, 1, 8), torch.zeros(2, 4, 1, 8),
            torch.zeros(2, 4, 1, 8), torch.ones(1, 1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), **k),
        "butterfly_linear_apply": lambda **k: bl.butterfly_linear_apply(
            spec, layer.params(), x8, **k),
        "ButterflyLinear": lambda **k: layer(x8, **k),
        "encdec.apply_B": lambda **k: encdec.apply_B(
            encdec.make_spec(gen, 8, 4, 2), w8, torch.randn(8, 4), **k),
        "lm.loss_fn": lambda **k: lm.loss_fn(model, batch, **k),
        "loss_and_grads": lambda **k: steps.loss_and_grads(model, batch,
                                                           **k),
        "ServeEngine": lambda **k: ServeEngine(cfg, model, slots=1,
                                               max_len=32, device="cpu",
                                               **k),
    }


ENTRY_POINTS = list(_entry_points())


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_backend_kwarg_is_rejected_everywhere(name):
    """``backend=`` raises TypeError at every entry point; ``context=``
    takes a backend string there."""
    call = _entry_points()[name]
    with pytest.raises(TypeError, match="unexpected keyword"):
        call(backend="torch")
    call(context="torch")


# ---------------------------------------------------------------------------
# The butterfly backward's one segment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,transpose,dtype", [
    (8, False, torch.float32), (64, True, torch.float32),
    (1024, False, torch.float32), (256, False, torch.bfloat16)])
def test_tiled_twin_gives_the_same_bits_at_every_segment(n, transpose,
                                                         dtype):
    """The backward takes one segment, ⌈√p⌉ (its kernel's register
    schedule): named explicitly it gives the bits of the unset field, the
    kernel's plain twin gives the autograd twin's dx (and dw to rounding),
    and segments 1 and p are refused before any work, naming ROADMAP
    item 7."""
    p = n.bit_length() - 1
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(37, n, generator=gen).to(dtype)
    w = torch.randn(p, 2, n, generator=gen) * 0.7
    g = torch.randn(37, n, generator=gen).to(dtype)
    base = kb.butterfly_bwd_tiled_plain(x, w, g, transpose=transpose,
                                        blocks=3)
    pdx, pdw = kb.butterfly_bwd_plain(x, w, g, transpose=transpose)
    assert torch.equal(base[0], pdx)
    torch.testing.assert_close(base[1], pdw, atol=1e-4, rtol=1e-5)
    dx, dw = kb.butterfly_backward(
        x, w, g, transpose=transpose,
        context=ExecutionContext(segment=kb.default_segment(p)))
    assert torch.equal(dx, pdx) and torch.equal(dw, pdw)
    for seg in (1, p):
        with pytest.raises(ValueError, match="item 7"):
            kb.butterfly_backward(x, w, g, transpose=transpose,
                                  context=ExecutionContext(segment=seg))


def test_segment_reaches_the_backward_through_butterfly_apply():
    """``ButterflyFn`` carries the forward's resolved context, segment
    included, to its backward, which autograd may run on another thread;
    a segment other than ⌈√p⌉ is refused at ``butterfly_apply``, before
    the forward, naming ROADMAP item 7."""
    x = torch.randn(5, 16, requires_grad=True)
    w = torch.randn(4, 2, 16, requires_grad=True)
    with use_execution(ExecutionContext(segment=2)):
        y = kb.butterfly_apply(x, w)
    assert y.grad_fn.context.segment == 2 == kb.default_segment(4)
    assert y.grad_fn.context.backend == "auto"
    y.sum().backward()
    dx, dw = kb.butterfly_bwd_plain(x, w, torch.ones(5, 16))
    assert torch.equal(x.grad, dx) and torch.equal(w.grad, dw)
    before = kb.butterfly_forward.launches
    for seg in (1, 3, 99):
        with pytest.raises(ValueError, match="item 7"):
            kb.butterfly_apply(x, w, context=ExecutionContext(segment=seg))
    assert kb.butterfly_forward.launches == before


# ---------------------------------------------------------------------------
# The engine freezes its context at construction
# ---------------------------------------------------------------------------

def test_engine_ignores_an_ambient_block_entered_after_construction():
    """An engine resolves one context when built; a ``use_execution``
    block entered later changes none of its tokens (and its ``cuda``
    would raise on the CPU, were it read). One built inside a ``torch``
    block keeps ``torch``."""
    from repro_torch.configs import registry
    from repro_torch.models.lm import LM
    from repro_torch.serve import Request, ServeEngine
    cfg = registry.get("smollm-135m-butterfly-smoke").with_(
        compute_dtype="float32")
    model = LM(cfg, generator=torch.Generator().manual_seed(0))
    prompts = [[5, 9, 2], list(range(1, 21))]

    def tokens(engine_ctx_block, tick_block):
        with use_execution(engine_ctx_block):
            eng = ServeEngine(cfg, model, slots=2, max_len=48, device="cpu")
        futs = [eng.submit(Request(prompt=p, max_new_tokens=5))
                for p in prompts]
        with use_execution(tick_block):
            eng.run_until_idle()
            replay = eng.compile_stats["replays"]
        return eng, [f.result().tokens for f in futs], replay

    eng0, want, _ = tokens(None, None)
    eng1, got, replays = tokens(None, ExecutionContext(backend="cuda"))
    assert got == want and sum(replays.values()) > 0
    assert eng0.context.backend == eng1.context.backend == "torch"
    eng2, got2, _ = tokens("torch", ExecutionContext(segment=1))
    assert got2 == want and eng2.context.backend == "torch"
    assert eng2.context.segment is None
