"""The dry-run's tables from its JSONs (``python -m
repro_torch.launch.report [dir ...]``).

Counterpart of ``repro.launch.report``: the roofline table, the detail
table and the diff of two runs, with the reference's columns where they
mean something on one H100. Collective traffic is none on one card, so
the ICI/DCN and collective columns are left out; the detail table gives
the tally's seconds and the microbatches in the compile columns' place,
and every HBM figure is argument bytes (``fit_basis`` in each JSON).
"""

from __future__ import annotations

import glob
import json
import os
import sys
from typing import Dict, List

from repro_torch.launch.roofline import CARD


def load(d: str) -> List[Dict]:
    out = []
    for p in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(p) as f:
            out.append(json.load(f))
    return out


def _hbm_gb(r: Dict) -> float:
    return (r["argument_bytes"] + r["temp_bytes"] + r["output_bytes"]
            - r["alias_bytes"]) / 1e9


def roofline_table(records: List[Dict], mesh: str = "h100x1") -> str:
    lines = [
        "| arch | shape | t_comp (ms) | t_mem (ms) | dominant "
        "| MODEL/tally flops | roofline frac | arg GB | fit |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in records:
        if r["mesh"] != mesh:
            continue
        if r.get("status") == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | — "
                         f"| — | — | {r['reason']} |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute'] * 1e3:.1f} "
            f"| {r['t_memory'] * 1e3:.1f} | {r['dominant']} "
            f"| {r['flops_utilization']:.2f} "
            f"| {r['roofline_fraction']:.3f} | {_hbm_gb(r):.1f} "
            f"| {'✅' if r['hbm_fit'] else '❌'} |")
    return "\n".join(lines)


def dryrun_table(records: List[Dict]) -> str:
    lines = [
        "| arch | shape | mesh | status | tally s | microbatches "
        "| FLOPs/dev | bytes/dev | arg GB |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in records:
        if r.get("status") == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"skipped | — | — | — | — | {r['reason']} |")
            continue
        mb = r.get("microbatches", r.get("batch_split", 1))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok "
            f"| {r.get('tally_seconds', 0):.1f} | {mb} "
            f"| {r['flops_per_device']:.2e} | {r['bytes_per_device']:.2e} "
            f"| {_hbm_gb(r):.1f} |")
    return "\n".join(lines)


def diff_table(base: List[Dict], new: List[Dict], cells: List) -> str:
    bmap = {(r["arch"], r["shape"], r["mesh"]): r for r in base}
    nmap = {(r["arch"], r["shape"], r["mesh"]): r for r in new}
    lines = ["| cell | term | before | after | Δ |", "|---|---|---|---|---|"]
    for key in cells:
        b, n = bmap.get(tuple(key)), nmap.get(tuple(key))
        if not b or not n or b.get("status") != "ok":
            continue
        for term in ("t_compute", "t_memory", "t_collective"):
            tb, tn = b[term] * 1e3, n[term] * 1e3
            if tb == 0 and tn == 0:
                continue
            d = (tb - tn) / tb * 100 if tb else 0.0
            lines.append(f"| {key[0]} × {key[1]} | {term[2:]} | {tb:.1f} ms "
                         f"| {tn:.1f} ms | {d:+.0f}% |")
    return "\n".join(lines)


def render(records: List[Dict]) -> str:
    """A roofline table a mesh (one card first, then the pods, whose
    terms are a card's share of the one-card tally and whose argument
    bytes are a card's under the sharding trees) and the detail table,
    headed with the card they are bounds for."""
    meshes = sorted({r["mesh"] for r in records},
                    key=lambda m: (m != "h100x1", m)) or ["h100x1"]
    out = []
    for mesh in meshes:
        what = "one H100" if mesh == "h100x1" else "a card of the pod"
        out += [f"## Roofline on {what} ({mesh}; {CARD})\n",
                roofline_table(records, mesh), ""]
    return "\n".join(out + ["## Dry-run detail\n", dryrun_table(records)])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    records = []
    for d in argv or ["experiments/dryrun"]:
        records += load(d)
    print(render(records))


if __name__ == "__main__":
    main()
