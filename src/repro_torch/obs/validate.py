"""Structural validator for Chrome trace-event JSON.

A copy of ``repro.obs.validate`` for the port, shared by the tests, the
serving CLI's users and ``chip_smoke.py``:

    python -m repro_torch.obs.validate trace.json

Checks (raising :class:`TraceValidationError` on the first violation):

* the document is ``{"traceEvents": [...]}`` (or a bare event list);
* every event carries ``ph``, ``ts``, ``pid``, ``tid``, ``name`` with
  sane types (``ph`` one of the phases we emit, ``ts``/``dur``
  non-negative numbers);
* per ``(pid, tid)`` track, complete ("X") spans are properly nested —
  a span either contains or is disjoint from every other span on its
  track (partial overlap is the classic symptom of a broken exporter
  and renders as garbage in Perfetto).

The validator is stdlib-only, so it runs wherever the trace is read.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List

__all__ = ["TraceValidationError", "validate_chrome_trace", "main"]

_PHASES = {"X", "i", "I", "M", "B", "E", "C"}
_EPS = 1e-6  # µs; timestamps are rounded to 1 ns by the tracer


class TraceValidationError(ValueError):
    """A trace-event document failed structural validation."""


def _fail(i: int, ev: Any, why: str) -> None:
    raise TraceValidationError(f"event[{i}] {why}: {ev!r}")


def validate_chrome_trace(doc: Any) -> List[Dict[str, Any]]:
    """Validate ``doc``; return the (non-metadata) event list on success."""
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            raise TraceValidationError(
                "document must carry a 'traceEvents' list")
    elif isinstance(doc, list):
        events = doc
    else:
        raise TraceValidationError(
            f"document must be a dict or list, got {type(doc).__name__}")

    spans: List[Dict[str, Any]] = []
    out: List[Dict[str, Any]] = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            _fail(i, ev, "is not an object")
        for field in ("ph", "ts", "pid", "tid", "name"):
            if field not in ev:
                _fail(i, ev, f"missing required field {field!r}")
        if not isinstance(ev["name"], str) or not ev["name"]:
            _fail(i, ev, "has a non-string/empty name")
        if ev["ph"] not in _PHASES:
            _fail(i, ev, f"has unknown phase {ev['ph']!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            _fail(i, ev, "has a negative or non-numeric ts")
        for field in ("pid", "tid"):
            if not isinstance(ev[field], int):
                _fail(i, ev, f"has a non-integer {field}")
        if "args" in ev and not isinstance(ev["args"], dict):
            _fail(i, ev, "has non-object args")
        if ev["ph"] == "X":
            if "dur" not in ev:
                _fail(i, ev, "is a complete span without dur")
            if not isinstance(ev["dur"], (int, float)) or ev["dur"] < 0:
                _fail(i, ev, "has a negative or non-numeric dur")
            spans.append(ev)
        if ev["ph"] != "M":
            out.append(ev)

    _check_nesting(spans)
    return out


def _check_nesting(spans: List[Dict[str, Any]]) -> None:
    by_track: Dict[tuple, List[Dict[str, Any]]] = {}
    for ev in spans:
        by_track.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    for track, evs in by_track.items():
        # parent-first: earlier start, and at equal start the longer span
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[float] = []  # open-span end times
        for ev in evs:
            t0, t1 = ev["ts"], ev["ts"] + ev["dur"]
            while stack and t0 >= stack[-1] - _EPS:
                stack.pop()
            if stack and t1 > stack[-1] + _EPS:
                raise TraceValidationError(
                    f"span {ev['name']!r} on track {track} "
                    f"[{t0}, {t1}] partially overlaps an enclosing span "
                    f"ending at {stack[-1]}")
            stack.append(t1)


def main(argv: List[str]) -> int:
    if len(argv) != 1:
        sys.stderr.write(
            "usage: python -m repro_torch.obs.validate TRACE.json\n")
        return 2
    with open(argv[0]) as fh:
        doc = json.load(fh)
    events = validate_chrome_trace(doc)
    tracks = {(e["pid"], e["tid"]) for e in events}
    spans = sum(1 for e in events if e["ph"] == "X")
    sys.stdout.write(
        f"{argv[0]}: OK — {len(events)} events ({spans} spans) on "
        f"{len(tracks)} tracks\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
