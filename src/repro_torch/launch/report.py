"""The dry run's summary table from ``results/dryrun_torch/*.json``.

The port's counterpart of the JAX package's ``launch/report.py``: the same
rows, table and counts over the port's one-card records (mesh ``"1"``),
with an explicit results directory and a mesh filter.
"""
from __future__ import annotations

import json
import pathlib
from typing import Optional, Union

# default location only — every entry point takes an explicit results dir
RESULTS = (pathlib.Path(__file__).resolve().parents[3] / "results"
           / "dryrun_torch")

_Path = Union[str, pathlib.Path]


def rows(mesh: Optional[str] = None, results_dir: Optional[_Path] = None):
    """Parsed result records, optionally filtered to one mesh shape.

    ``mesh`` keeps only records whose ``"mesh"`` field matches, plus
    skipped records (they carry no mesh — a skip is mesh-independent).
    ``results_dir`` overrides the default ``results/dryrun_torch``.
    """
    base = pathlib.Path(results_dir) if results_dir is not None else RESULTS
    out = []
    for p in sorted(base.glob("*.json")):
        if any(p.stem.endswith(t) for t in ("_flash", "_opt", "_exp")):
            continue
        r = json.loads(p.read_text())
        if mesh and not r.get("skipped") and r.get("mesh") != mesh:
            continue
        out.append(r)
    return out


def markdown(mesh: str = "1", results_dir: Optional[_Path] = None) -> str:
    hdr = ("| arch | shape | status | temp GB/dev | args GB/dev | "
           "flops/dev | coll bytes/dev | trace s |\n"
           "|---|---|---|---|---|---|---|---|\n")
    lines = [hdr]
    for r in rows(mesh, results_dir=results_dir):
        if r.get("skipped"):
            lines.append(f"| {r['arch']} | {r['shape']} | SKIP "
                         f"({r['reason'][:40]}...) | | | | | |\n")
            continue
        if not r.get("ok"):
            mem = r.get("memory")
            what = (f"**OOM** ({mem['peak_bytes'] / 1e9:.1f} GB)"
                    if r.get("oom") and mem else "**FAIL**")
            lines.append(f"| {r['arch']} | {r['shape']} | {what} "
                         f"| | | | | |\n")
            continue
        mem = r["memory"]
        h = r.get("hlo_analysis", {})
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | "
            f"{mem['temp_bytes']/1e9:.1f} | "
            f"{mem['argument_bytes']/1e9:.2f} | "
            f"{h.get('flops', 0):.2e} | "
            f"{h.get('collective_total_bytes', 0):.2e} | "
            f"{r.get('compile_s', 0):.0f} |\n")
    return "".join(lines)


def status_counts(mesh: Optional[str] = None,
                  results_dir: Optional[_Path] = None):
    ok = fail = skip = 0
    for r in rows(mesh, results_dir=results_dir):
        if r.get("skipped"):
            skip += 1
        elif r.get("ok"):
            ok += 1
        else:
            fail += 1
    return ok, fail, skip


if __name__ == "__main__":
    import sys
    mesh = sys.argv[1] if len(sys.argv) > 1 else "1"
    print(markdown(mesh))
    print("status:", status_counts())
