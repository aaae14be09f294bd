"""The Hopper tile rule (`repro_torch.kernels.tuning`) against the
reference's (`repro.kernels.tuning`) and against the launches the kernels
made before the rule existed, on the CPU.

``default_segment`` is the reference's; the override order is the
reference's (explicit, the ambient context, ``REPRO_TUNE_BLOCK_B`` /
``REPRO_TUNE_SEGMENT``, the rule), and every override the kernels cannot
take is refused with ``ValueError`` naming what they take; the TPU knobs
are not read; ``describe()`` and ``cache_entries()`` keep the reference's
keys and text, and the CPU route records nothing. By default the rule
gives what the wrappers launched before it: the sandwich forward's column
groups, the butterfly backward's row slots and the flash backward's owned
rows (the formulas as they stood, copied here), and the butterfly
backward's shared-memory model matches the sizes its kernel plans with.
"""

import pytest
import torch

from repro.kernels import tuning as jtuning
from repro_torch.kernels import butterfly as kb
from repro_torch.kernels import context as exctx
from repro_torch.kernels import sandwich as ks
from repro_torch.kernels import tuning
from repro_torch.kernels.context import ExecutionContext, use_execution
from test_torch_chip_smoke import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("REPRO_TUNE_BLOCK_B", "REPRO_TUNE_SEGMENT",
                "REPRO_TUNE_BLOCK_Q", "REPRO_TUNE_VMEM_BUDGET"):
        monkeypatch.delenv(var, raising=False)
    tuning.clear_choices()
    yield
    tuning.clear_choices()


# -- the formulas the wrappers launched with before the rule ----------------

def _groups_before(rows: int, chunks: int, sms: int) -> int:
    tiles = -(-rows // 64)
    if chunks >= 64:
        return min(chunks, -(-sms // tiles))
    return min(chunks, max(1, (sms + tiles // 2) // tiles))


def _row_slots_before(n: int) -> int:
    return max(1, 2 * 512 // n)


def _tile_rows_before(D: int, dtype: str) -> tuple:
    """``flash_common.cuh``'s ``BwdSplit``: dq's then dkv's owned rows."""
    dmax = 64 if D <= 64 else 128 if D <= 128 else 256
    out = []
    for dq in (True, False):
        split = 2 if dmax > 128 or (dtype == "float32" and not dq
                                    and dmax > 64) else 1
        out.append(64 // split)
    return tuple(out)


def test_default_segment_is_the_references():
    for p in range(1, 16):
        assert tuning.default_segment(p) == jtuning.default_segment(p)
        assert kb.default_segment(p) == jtuning.default_segment(p)


def test_rule_reproduces_the_launches_before_it():
    """No choice changes a launch: the column groups over rows, chunks and
    SM counts, the butterfly backward's row slots, the flash kernels'
    owned rows, and the compiled row tiles as the rule's defaults."""
    for sms in (1, 66, 132):
        for rows in (1, 8, 63, 64, 65, 200, 8192, 70000):
            for chunks in (1, 5, 12, 42, 63, 64, 512, 2048):
                assert tuning.sandwich_groups(rows, chunks, sms) == \
                    _groups_before(rows, chunks, sms)
    for p in range(1, 16):
        assert tuning.row_slots(1 << p) == _row_slots_before(1 << p)
    for D in range(8, 257, 8):
        for dtype in ("float32", "bfloat16"):
            assert tuning.flash_blocks(D, dtype, "bwd") == \
                _tile_rows_before(D, dtype)
            assert tuning.flash_blocks(D, dtype, "fwd") == (64, 64)
    assert tuning.resolve_block_b("sandwich", 2048, "bfloat16", "fwd") == 64
    assert tuning.resolve_block_b("sandwich", 2048, "bfloat16", "bwd") == 32
    for n, rows in ((4, 128), (64, 16), (1024, 16), (2048, 2), (32768, 1)):
        assert tuning.resolve_block_b("butterfly", n, "float32", "fwd") == \
            rows


@pytest.mark.parametrize("n,dtype,tile,in_device", [
    # (n, dtype, the plan's largest tile on 227 KB, tiles in device memory)
    (2, "float32", 14336, False), (64, "float32", 160, False),
    (64, "bfloat16", 256, False), (1024, "float32", 8, False),
    (1024, "bfloat16", 12, False), (4096, "float32", 2, False),
    (8192, "bfloat16", 1, False), (16384, "float32", 1, True),
    (32768, "bfloat16", 1, True)])
def test_butterfly_backward_model_matches_its_plan(n, dtype, tile,
                                                   in_device):
    """``plan_p`` of ``csrc/butterfly_bwd.cu``: the largest tile whose x,
    checkpoint and g rows (padded n + n/8, a second x and g for float32
    up to 4096) fit 227 KB, in multiples of the rows a block works at
    once; n >= 16384 keeps its one-row tile in device memory."""
    c = tuning.choice("butterfly", n, dtype, "bwd")
    assert (c.block_b, c.tiles_in_device_memory) == (tile, in_device)
    assert c.takes[-1] == tile and c.smem_bytes <= c.smem_limit
    assert c.segment == tuning.default_segment(n.bit_length() - 1)


def test_override_order_and_refusals(monkeypatch):
    """explicit > REPRO_TUNE_BLOCK_B > the rule, for a tile the launch
    takes (the butterfly backward's tile rows at n = 1024: multiples of
    2 up to 8); refused with the values the kernel takes, before any work,
    at every compiled tile and past the shared memory; ``segment`` the
    same way, ⌈√p⌉ alone."""
    rule = tuning.resolve_block_b("butterfly", 1024, "float32", "bwd")
    assert rule == 8
    monkeypatch.setenv("REPRO_TUNE_BLOCK_B", "4")
    assert tuning.resolve_block_b("butterfly", 1024, "float32", "bwd") == 4
    assert tuning.resolve_block_b("butterfly", 1024, "float32", "bwd",
                                  2) == 2
    monkeypatch.delenv("REPRO_TUNE_BLOCK_B")
    for kernel, n, mode, b, takes in (
            ("butterfly", 1024, "bwd", 3, "multiples of 2 up to 8"),
            ("butterfly", 1024, "bwd", 10, "multiples of 2 up to 8"),
            ("butterfly", 1024, "fwd", 8, "block_b 16 "),
            ("butterfly", 32768, "bwd", 2, "block_b 1 "),
            ("sandwich", 2048, "fwd", 32, "block_b 64 "),
            ("sandwich", 2048, "bwd", 64, "block_b 32 "),
            ("flash", 64, "fwd", 64, "take no block_b")):
        with pytest.raises(ValueError, match=takes):
            tuning.resolve_block_b(kernel, n, "float32", mode, b)
    assert tuning.resolve_segment(9) == 3
    assert tuning.resolve_segment(9, 3) == 3
    monkeypatch.setenv("REPRO_TUNE_SEGMENT", "2")
    with pytest.raises(ValueError, match="item 7"):
        tuning.resolve_segment(9)
    assert tuning.resolve_segment(9, 3) == 3      # explicit beats the env
    monkeypatch.delenv("REPRO_TUNE_SEGMENT")
    with pytest.raises(ValueError, match="segment ⌈√p⌉ = 3"):
        tuning.resolve_segment(9, 4)


def test_overrides_reach_the_entry_points():
    """Through the wrappers: the ambient block's ``block_b``, an explicit
    context over it, and the config's, each checked before any work on the
    CPU route too; an honoured one changes no bit of the plain route."""
    x = torch.randn(6, 1024)
    w = torch.randn(10, 2, 1024) * 0.5
    g = torch.randn(6, 1024)
    base = kb.butterfly_backward(x, w, g)
    with use_execution(ExecutionContext(block_b=3)):
        with pytest.raises(ValueError, match="multiples of 2"):
            kb.butterfly_backward(x, w, g)
        got = kb.butterfly_backward(x, w, g,
                                    context=ExecutionContext(block_b=4))
    assert all(torch.equal(a, b) for a, b in zip(got, base))
    # a differentiable call needs a tile both directions take: none at
    # n = 1024 (16 rows forward, at most 8 backward), 2 at n = 2048
    with pytest.raises(ValueError, match="block_b 16"):
        kb.butterfly_apply(x.requires_grad_(), w,
                           context=ExecutionContext(block_b=8))
    with pytest.raises(ValueError, match="multiples of 2 up to 8"):
        kb.butterfly_apply(x, w, context=ExecutionContext(block_b=16))
    x2 = torch.randn(6, 2048, requires_grad=True)
    y = kb.butterfly_apply(x2, torch.randn(11, 2, 2048),
                           context=ExecutionContext(block_b=2))
    y.sum().backward()
    b_in = torch.randn(6, 2, 64)
    core = torch.randn(4, 6)
    b_out = torch.randn(7, 2, 128)
    idx_in = torch.arange(6, dtype=torch.int32)
    idx_out = torch.arange(4, dtype=torch.int32)
    args = (torch.randn(3, 50), b_in, core, b_out, idx_in, idx_out)
    kw = dict(scale_in=1.0, scale_out=1.0, n_out=100)
    with torch.no_grad():
        ks.sandwich_forward(*args, **kw, context=ExecutionContext(block_b=64))
        with pytest.raises(ValueError, match="block_b 64"):
            ks.sandwich_forward(*args, **kw,
                                context=ExecutionContext(block_b=32))
    # a differentiable call needs both directions' tiles: none is common
    with pytest.raises(ValueError, match="block_b 32"):
        ks.sandwich_forward(args[0], b_in.requires_grad_(), *args[2:], **kw,
                            context=ExecutionContext(block_b=64))
    assert exctx.resolve_execution(ExecutionContext(block_b=5)).block_b == 5


def test_tpu_knobs_are_not_read(monkeypatch):
    before = tuning.choice("butterfly", 1024, "float32", "bwd")
    monkeypatch.setenv("REPRO_TUNE_VMEM_BUDGET", "1024")
    monkeypatch.setenv("REPRO_TUNE_BLOCK_Q", "8")
    assert tuning.choice("butterfly", 1024, "float32", "bwd") == before
    assert tuning.flash_blocks(64, "bfloat16", "bwd") == (64, 64)


def test_describe_and_cache_entries_follow_the_reference():
    """An empty record reads as the reference's; choices are keyed
    ``kernel/mode/n<n>/<dtype>`` and described one summary each, sorted,
    joined by ``; ``; the CPU route queries nothing."""
    assert tuning.describe() == "no kernel tuning queried"
    kb.butterfly_forward(torch.randn(3, 64), torch.randn(6, 2, 64))
    assert tuning.cache_entries() == {}
    a = tuning.tune("butterfly", 1024, "float32", "bwd")
    b = tuning.tune("sandwich", 2048, torch.bfloat16, "fwd", k1=10, k2=11,
                    n1=1024)
    jkeys = set()
    for kernel, n, dt, mode in (("butterfly", 1024, "float32", "bwd"),
                                ("sandwich", 2048, "bfloat16", "fwd")):
        jtuning.tune(kernel, n, dt, mode)
        jkeys.add(f"{kernel}/{mode}/n{n}/{dt}")
    assert set(tuning.cache_entries()) == jkeys <= \
        set(jtuning.cache_entries())
    assert tuning.describe() == "; ".join(sorted([a.summary(),
                                                  b.summary()]))
    assert a.summary().startswith(
        "butterfly/bwd n=1024 float32: block_b=8 segment=4")
    assert "smem=" in b.summary() and "of 227KB" in b.summary()
