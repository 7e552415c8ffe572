"""Render an observability snapshot to markdown (the port of the JAX
package's ``obs/report.py``; the same tables from the same metrics).

Three views over the same process-local state:

  * :func:`render_markdown` — the full dump: metric catalog (counters,
    gauges, histogram percentiles), event counts per kind, and the span
    tree in completion order.
  * :func:`slo_report` — the serving tier's SLO table: p50/p90/p99 of
    every ``serve.*`` histogram (queue wait, padding waste, end-to-end
    latency, decode throughput).
  * :func:`cost_model_report` — predicted-vs-measured dispatch accounting:
    one row per ``cost_observation`` event plus the aggregate
    ``planner.cost_model_error`` percentiles, so a planner mispricing shows
    as a large error ratio.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

__all__ = ["render_markdown", "slo_report", "cost_model_report"]


def _fmt(v, nd: int = 3) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return str(v)


def _hist_rows(snap: Dict[str, dict], prefix: str = ""):
    return [(name, m) for name, m in snap.items()
            if m["type"] == "histogram" and name.startswith(prefix)
            and m["count"]]


def render_markdown(snapshot: Optional[Dict[str, dict]] = None) -> str:
    """Everything recorded so far, as one markdown document."""
    snap = _metrics.snapshot() if snapshot is None else snapshot
    out = ["## Observability snapshot\n"]

    scalars = [(n, m) for n, m in snap.items()
               if m["type"] in ("counter", "gauge")]
    if scalars:
        out.append("### Metrics\n\n| metric | type | value |\n|---|---|---|\n")
        for name, m in scalars:
            out.append(f"| {name} | {m['type']} | {_fmt(m['value'])} |\n")
        out.append("\n")

    hists = _hist_rows(snap)
    if hists:
        out.append("### Histograms\n\n"
                   "| metric | count | p50 | p90 | p99 | max |\n"
                   "|---|---|---|---|---|---|\n")
        for name, m in hists:
            out.append(f"| {name} | {m['count']} | {_fmt(m['p50'])} | "
                       f"{_fmt(m['p90'])} | {_fmt(m['p99'])} | "
                       f"{_fmt(m['max'])} |\n")
        out.append("\n")

    events = _trace.events()
    if events:
        kinds: Dict[str, int] = {}
        for e in events:
            kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
        out.append("### Events\n\n| kind | count |\n|---|---|\n")
        for kind, cnt in sorted(kinds.items()):
            out.append(f"| {kind} | {cnt} |\n")
        out.append("\n")

    spans = _trace.spans()
    if spans:
        out.append("### Spans\n\n"
                   "| span | wall ms | device ms | attrs |\n|---|---|---|---|\n")
        for s in spans:
            label = "&nbsp;&nbsp;" * s["depth"] + s["name"]
            attrs = ", ".join(f"{k}={_fmt(v)}" for k, v in s["attrs"].items())
            out.append(f"| {label} | {_fmt(s['wall_ms'])} | "
                       f"{_fmt(s['device_ms'])} | {attrs} |\n")
    return "".join(out)


def slo_report(prefix: str = "serve.") -> str:
    """SLO table of every ``serve.*`` histogram — the north star's "heavy
    traffic" claim rendered as numbers (p50/p90/p99 + throughput)."""
    snap = _metrics.snapshot()
    hists = _hist_rows(snap, prefix)
    if not hists:
        return ("## Serve SLO report\n\n(no serve metrics recorded — "
                "enable observability with repro_torch.obs.enable())\n")
    out = ["## Serve SLO report\n\n",
           "| metric | count | p50 | p90 | p99 | max |\n",
           "|---|---|---|---|---|---|\n"]
    for name, m in hists:
        out.append(f"| {name} | {m['count']} | {_fmt(m['p50'])} | "
                   f"{_fmt(m['p90'])} | {_fmt(m['p99'])} | {_fmt(m['max'])} |\n")
    for name, m in snap.items():
        if name.startswith(prefix) and m["type"] in ("counter", "gauge") \
                and m["value"] is not None:
            out.append(f"| {name} | - | {_fmt(m['value'])} | | | |\n")
    return "".join(out)


def cost_model_report() -> str:
    """Predicted-vs-measured per plan decision, worst mispricing first."""
    obs = _trace.events("cost_observation")
    out = ["## Cost-model accounting\n\n"]
    err = _metrics.histogram("planner.cost_model_error")
    if err.count:
        out.append(f"`cost_model_error` (measured/predicted ratio): "
                   f"p50 {_fmt(err.percentile(50))}, "
                   f"p99 {_fmt(err.percentile(99))}, "
                   f"max {_fmt(err.max)} over {err.count} observations\n\n")
    if not obs:
        out.append("(no cost observations — run a sort with tracing on)\n")
        return "".join(out)
    out.append("| op | n | k | method | predicted ns | measured ns | "
               "error x |\n|---|---|---|---|---|---|---|\n")
    key = lambda e: -(e.get("error") or 0.0)          # noqa: E731
    for e in sorted(obs, key=key):
        out.append(f"| {e.get('op')} | {e.get('n')} | {_fmt(e.get('k'))} | "
                   f"{e.get('method')} | {_fmt(e.get('predicted_ns'))} | "
                   f"{_fmt(e.get('measured_ns'))} | "
                   f"{_fmt(e.get('error'))} |\n")
    return "".join(out)
