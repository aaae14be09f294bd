"""The zoo's configs in the port (`repro_torch.configs`) against the JAX
reference, and the port's refusal of the archs it does not build yet.

Every registry name (ten archs, each as the base, `-smoke`, `-butterfly`
and `-butterfly-smoke`) must equal the reference's config field for field,
and `SHAPES`, `LONG_CONTEXT_OK` and `cell_applicable` must agree. The
archs with encoder or frontend blocks are refused by the model, the page
pool, the engine and both command lines, naming their ROADMAP sub-item
(queue 1, item 5d); gemma3-27b, with its `local` blocks, and the
recurrent archs recurrentgemma-2b and xlstm-125m are ported.
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

VARIANTS = ("", "-smoke", "-butterfly", "-butterfly-smoke")
NAMES = [a + v for a in jreg.names() for v in VARIANTS]
SERVED = ("olmoe-1b-7b", "dbrx-132b", "smollm-135m", "gemma-7b",
          "mistral-large-123b", "gemma3-27b", "recurrentgemma-2b",
          "xlstm-125m")
REFUSED = {"internvl2-1b": "5d", "seamless-m4t-medium": "5d"}


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
    assert set(SERVED) | set(REFUSED) == set(jreg.names())


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
    for v in VARIANTS:
        assert tlm.unported_reason(treg.get(arch + v)) is None


@pytest.mark.parametrize("arch", sorted(REFUSED))
def test_unported_archs_are_refused_naming_their_sub_item(arch):
    item = f"item {REFUSED[arch]}"
    cfg = treg.get(arch + "-smoke")
    with pytest.raises(ValueError, match=item):
        tlm.LM(cfg)
    with pytest.raises(ValueError, match=item):
        PagedCachePool(cfg, 2, 32, device="cpu")
    with pytest.raises(ValueError, match=item):
        ServeEngine(cfg, tlm.LM(treg.get("smollm-135m-smoke")), slots=2,
                    max_len=32, device="cpu")
    with pytest.raises(SystemExit, match=item):
        serve_cli.main(["--device", "cpu", "--arch", arch + "-smoke"])
    with pytest.raises(SystemExit, match=item):
        train_cli.main(["--device", "cpu", "--arch", arch + "-butterfly"])


def test_clis_refuse_unknown_archs():
    for cli in (serve_cli, train_cli):
        with pytest.raises(SystemExit, match="unknown architecture"):
            cli.main(["--device", "cpu", "--arch", "gpt-2"])
