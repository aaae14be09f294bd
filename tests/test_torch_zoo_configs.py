"""The zoo's configs in the port (`repro_torch.configs`) against the JAX
reference, and every arch built by the port.

Every registry name (ten archs, each as the base, `-smoke`, `-butterfly`
and `-butterfly-smoke`) must equal the reference's config field for field,
and `SHAPES`, `LONG_CONTEXT_OK` and `cell_applicable` must agree. Every
arch builds; the archs with a frontend or an encoder (internvl2-1b,
seamless-m4t-medium) are also built by the page pool and the engine and
run by both command lines at smoke size, and a block type the reference
does not know is refused.
"""

import dataclasses

import pytest

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import lm as tlm
from repro_torch.serve import ServeEngine
from repro_torch.serve.cache import (PagedCachePool,
                                     chunked_prefill_supported,
                                     paged_supported)
from test_torch_chip_smoke import one_torch_thread  # noqa: F401

VARIANTS = ("", "-smoke", "-butterfly", "-butterfly-smoke")
NAMES = [a + v for a in jreg.names() for v in VARIANTS]
SERVED = ("olmoe-1b-7b", "dbrx-132b", "smollm-135m", "gemma-7b",
          "mistral-large-123b", "gemma3-27b", "recurrentgemma-2b",
          "xlstm-125m", "internvl2-1b", "seamless-m4t-medium")
FRONTENDS = ("internvl2-1b", "seamless-m4t-medium")


def _as_dict(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = (dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                       else v)
    return out


def test_registry_holds_the_reference_archs():
    assert treg.names() == jreg.names()
    assert len(NAMES) == 40
    assert set(SERVED) == set(jreg.names())


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_reference_field_for_field(name):
    want, got = jreg.get(name), treg.get(name)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert _as_dict(got) == _as_dict(want)
    for prop in ("head_dim_", "unit_repeats", "tail_layers", "lru_width_"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert str(got.pdtype()).split(".")[-1] == str(want.pdtype())
    assert str(got.cdtype()).split(".")[-1] == str(want.cdtype())
    assert paged_supported(got) == _jcache().paged_supported(want)
    assert chunked_prefill_supported(got) == \
        _jcache().chunked_prefill_supported(want)


def _jcache():
    from repro.serve import cache
    return cache


def test_butterfly_variant_unties_the_head():
    for name in ("gemma-7b", "recurrentgemma-2b"):
        assert treg.get(name).tie_embeddings
        assert not treg.get(name + "-butterfly").tie_embeddings
        assert not treg.get(name + "-butterfly-smoke").tie_embeddings


def test_shapes_and_cells_equal_reference():
    assert [dataclasses.asdict(s) for s in tbase.SHAPES] == \
        [dataclasses.asdict(s) for s in jbase.SHAPES]
    assert list(tbase.SHAPES_BY_NAME) == list(jbase.SHAPES_BY_NAME)
    assert tbase.LONG_CONTEXT_OK == jbase.LONG_CONTEXT_OK
    for arch in jreg.names():
        for js, ts in zip(jbase.SHAPES, tbase.SHAPES):
            assert tbase.cell_applicable(treg.get(arch), ts) == \
                jbase.cell_applicable(jreg.get(arch), js)
    with pytest.raises(KeyError, match="unknown architecture"):
        treg.get("gpt-2")


@pytest.mark.parametrize("arch", SERVED)
def test_served_archs_are_ported(arch):
    """Every variant of the arch builds, its smoke variant's blocks in the
    reference's layer order."""
    for v in VARIANTS:
        assert treg.get(arch + v).name == arch + v
    cfg = treg.get(arch + "-smoke")
    model = tlm.LM(cfg)
    assert [layer.btype for layer in model.layers] == \
        list(tlm.layer_types(cfg))
    assert len(getattr(model, "enc_layers", ())) == cfg.n_enc_layers


@pytest.mark.parametrize("arch", sorted(FRONTENDS))
def test_unported_archs_are_refused_naming_their_sub_item(arch, capsys):
    """The frontend and encoder archs are built by the model, the page
    pool and the engine, and both command lines run their smoke variants;
    a block type the reference does not know is refused by name."""
    cfg = treg.get(arch + "-smoke")
    model = tlm.LM(cfg)
    assert hasattr(model, "frontend_proj")
    pool = PagedCachePool(cfg, 2, 32, device="cpu")
    assert pool.max_len_total == 32 + (cfg.frontend_tokens
                                       if cfg.frontend == "vision" else 0)
    eng = ServeEngine(cfg, model, slots=2, max_len=32, device="cpu")
    assert eng.prefill_chunk is None
    doc = serve_cli.main(["--device", "cpu", "--arch", arch + "-smoke",
                          "--requests", "2", "--max-new", "2",
                          "--max-len", "32", "--max-prompt", "12"])
    assert doc["summary"]["requests_finished"] == 2
    res = train_cli.main(["--device", "cpu", "--arch",
                          arch + "-butterfly-smoke", "--steps", "1",
                          "--seq-len", "8", "--global-batch", "1"])
    assert res.steps_run == 1
    with pytest.raises(ValueError, match="unknown block type 'ssm'"):
        tlm.LM(cfg.with_(block_unit=("ssm",)))


def test_clis_refuse_unknown_archs():
    for cli in (serve_cli, train_cli):
        with pytest.raises(SystemExit, match="unknown architecture"):
            cli.main(["--device", "cpu", "--arch", "gpt-2"])
