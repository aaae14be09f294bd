"""The port's seeded load generator (`repro_torch.serve.trace`) against the
reference's (`repro.serve.trace`): the same spec and vocabulary must give
byte-identical prompts and arrival offsets, for several seeds, rates and
both mixes; and the reference's own cases of `tests/test_serve_trace.py`
(determinism, stream splitting, mixes, validation, open-loop replay on a
virtual clock) hold for the port. Pure Python and numpy: no engine."""

import struct

import numpy as np
import pytest

from repro.serve import trace as jtrace
from repro_torch.serve import QueueFull, Request
from repro_torch.serve.trace import (MIXES, TraceItem, TraceSpec, generate,
                                     replay)

VOCAB = 128


def _bytes(items):
    """Every prompt token and arrival offset of a trace, as raw bytes."""
    out = bytearray()
    for it in items:
        out += struct.pack("<d", it.arrival_s)
        out += np.asarray(it.prompt, np.int64).tobytes()
        out += struct.pack("<q", it.max_new_tokens)
    return bytes(out)


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("seed,rate", [(0, 0.0), (1, 5.0), (3, 100.0),
                                       (7, 10.0), (12345, 250.0)])
def test_generate_is_byte_identical_to_reference(mix, seed, rate):
    kw = dict(requests=40, seed=seed, rate=rate, min_prompt=4,
              max_prompt=48, mix=mix, chunk=16, max_new_tokens=8)
    for vocab in (VOCAB, 49152):
        got = generate(TraceSpec(**kw), vocab)
        want = jtrace.generate(jtrace.TraceSpec(**kw), vocab)
        assert _bytes(got) == _bytes(want)
        assert [type(v) for it in got for v in it.prompt] == \
            [int] * sum(len(it.prompt) for it in got)


def test_full_width_cli_trace_is_byte_identical_to_reference():
    """The trace ``chip_smoke.py`` replays at full width: 32 requests,
    uniform prompts 5-200 tokens, open loop at 10 req/s."""
    kw = dict(requests=32, seed=0, rate=10.0, min_prompt=5, max_prompt=200,
              mix="uniform", chunk=16, max_new_tokens=32)
    assert _bytes(generate(TraceSpec(**kw), 49152)) == \
        _bytes(jtrace.generate(jtrace.TraceSpec(**kw), 49152))


def test_same_spec_same_trace():
    spec = TraceSpec(requests=16, seed=5, rate=40.0, mix="bimodal",
                     chunk=16, min_prompt=4, max_prompt=32)
    assert generate(spec, VOCAB) == generate(spec, VOCAB)


def test_rate_changes_arrivals_not_prompts():
    slow = generate(TraceSpec(requests=12, seed=1, rate=5.0), VOCAB)
    fast = generate(TraceSpec(requests=12, seed=1, rate=500.0), VOCAB)
    assert [i.prompt for i in slow] == [i.prompt for i in fast]
    assert [i.arrival_s for i in slow] != [i.arrival_s for i in fast]


def test_seed_changes_both_streams():
    a = generate(TraceSpec(requests=8, seed=1, rate=50.0), VOCAB)
    b = generate(TraceSpec(requests=8, seed=2, rate=50.0), VOCAB)
    assert [i.prompt for i in a] != [i.prompt for i in b]


def test_closed_burst_arrives_at_zero_and_arrivals_are_monotone():
    items = generate(TraceSpec(requests=5, seed=0, rate=0.0), VOCAB)
    assert [i.arrival_s for i in items] == [0.0] * 5
    arr = [i.arrival_s for i in
           generate(TraceSpec(requests=10, seed=3, rate=100.0), VOCAB)]
    assert arr[0] == 0.0 and arr == sorted(arr)


def test_mix_bounds():
    for it in generate(TraceSpec(requests=64, seed=7, min_prompt=4,
                                 max_prompt=9), VOCAB):
        assert 4 <= len(it.prompt) <= 9
        assert all(0 <= t < VOCAB for t in it.prompt)
    spec = TraceSpec(requests=32, seed=7, mix="bimodal", chunk=8,
                     min_prompt=4, max_prompt=24)
    for i, it in enumerate(generate(spec, VOCAB)):
        lo, hi = (4, 8) if i % 2 == 0 else (9, 24)
        assert lo <= len(it.prompt) <= hi


def test_spec_validation():
    with pytest.raises(ValueError, match="requests"):
        TraceSpec(requests=0)
    with pytest.raises(ValueError, match="rate"):
        TraceSpec(requests=1, rate=-1.0)
    with pytest.raises(ValueError, match="mix"):
        TraceSpec(requests=1, mix="zipf")
    with pytest.raises(ValueError, match="min_prompt"):
        TraceSpec(requests=1, min_prompt=9, max_prompt=4)
    with pytest.raises(ValueError, match="bimodal"):
        TraceSpec(requests=1, mix="bimodal", chunk=64, min_prompt=4,
                  max_prompt=32)
    with pytest.raises(ValueError, match="max_new_tokens"):
        TraceSpec(requests=1, max_new_tokens=0)
    with pytest.raises(ValueError, match="vocab_size"):
        generate(TraceSpec(requests=1), 0)


def test_item_request_overrides():
    it = TraceItem(arrival_s=0.0, prompt=(1, 2, 3), max_new_tokens=4)
    req = it.request(rid=9, deadline_s=1.5)
    assert isinstance(req, Request)
    assert req.rid == 9 and req.deadline_s == 1.5
    assert tuple(req.prompt) == (1, 2, 3) and req.max_new_tokens == 4


def test_replay_paces_open_loop_and_counts_shed():
    """Virtual clock: replay sleeps up to each absolute arrival offset,
    sheds QueueFull without retrying, and returns futures in submission
    order; the reference's replay takes the same sleeps."""
    items = [TraceItem(arrival_s=t, prompt=(1,), max_new_tokens=1)
             for t in (0.0, 0.1, 0.25)]

    def drive(replay_fn, item_list, queue_full):
        now, sleeps, submitted = [0.0], [], []

        def sleep(dt):
            sleeps.append(round(dt, 6))
            now[0] += dt

        def submit(req):
            submitted.append(req)
            if len(submitted) == 2:
                raise queue_full(1)
            return f"fut{len(submitted)}"

        futs, shed = replay_fn(submit, item_list, clock=lambda: now[0],
                               sleep=sleep)
        return futs, shed, sleeps

    got = drive(replay, items, QueueFull)
    assert got == (["fut1", "fut3"], 1, [0.1, 0.15])
    from repro.serve import QueueFull as JQueueFull
    jitems = [jtrace.TraceItem(arrival_s=i.arrival_s, prompt=i.prompt,
                               max_new_tokens=1) for i in items]
    assert drive(jtrace.replay, jitems, JQueueFull) == got


def test_replay_forwards_request_kw_and_calls_callables():
    items = [TraceItem(arrival_s=0.0, prompt=(1, 2), max_new_tokens=1)
             for _ in range(3)]
    seen = []
    counter = iter(range(100))

    def submit(req):
        seen.append((req.deadline_s, req.rid))
        return None

    replay(submit, items,
           request_kw={"deadline_s": 9.0, "rid": lambda: next(counter)},
           clock=lambda: 0.0, sleep=lambda dt: None)
    assert seen == [(9.0, 0), (9.0, 1), (9.0, 2)]   # fresh per item
