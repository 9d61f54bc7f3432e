"""Run-report rendering: telemetry ring + tracer -> markdown/JSON
artifacts (the reference's ``obs/report.py``, ported by copy).

Pure data-shuffling on the host — rendering touches no device — so it is
usable from tests, benchmarks, and CI. ``default_meta`` gives the run's
provenance on this side: the torch and CUDA versions and the card's name.
"""
from __future__ import annotations

import json
import os
import platform
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs import telemetry as obs_telemetry

# max convergence-curve rows rendered into the markdown table (the JSON
# artifact always carries every surviving ring record)
_CURVE_ROWS = 24


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if np.isnan(v):
            return "nan"
        return f"{v:.6g}"
    return str(v)


def default_meta(**extra) -> Dict:
    """The run's provenance: torch's version, the CUDA it was built for and
    the first card's name ("none" without one), the host and a UTC
    timestamp, then ``extra``."""
    import torch

    meta = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "device": (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                   else "none"),
        "host": platform.node(),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    meta.update(extra)
    return meta


def build_report(
    *,
    meta: Dict,
    runs: Optional[List[Dict]] = None,
    tracer=None,
) -> Dict:
    """Assemble the JSON-shaped report.

    ``meta``: run provenance (git sha, torch/CUDA/card info from
    ``default_meta``, timestamp, ...).
    ``runs``: one entry per solve — ``{"name", "backend", "ring"?,
    "iterations", "n_dots", "seconds"?, "objective"?, "gap"?,
    "comm_fraction"?}`` where ``ring`` is a TelemetryRing (or an
    already-decoded ``ring_to_records`` dict).
    ``tracer``: an ``obs.trace.Tracer`` for the time breakdown/counters.
    """
    report: Dict = {"meta": dict(meta), "runs": []}
    for run in runs or []:
        entry = {k: v for k, v in run.items() if k != "ring"}
        ring = run.get("ring")
        if ring is not None:
            records = (
                ring if isinstance(ring, dict)
                else obs_telemetry.ring_to_records(ring)
            )
            entry["records"] = {
                name: np.asarray(col).tolist() for name, col in records.items()
            }
            events = np.asarray(records["event"], np.int64)
            entry["event_counts"] = {
                obs_telemetry.EVENT_NAMES[code]: int((events == code).sum())
                for code in range(len(obs_telemetry.EVENT_NAMES))
                if int((events == code).sum())
            }
        report["runs"].append(entry)
    if tracer is not None:
        report["spans"] = tracer.span_table()
        report["counters"] = tracer.counter_table()
    return report


def _curve_table(records: Dict[str, list]) -> List[str]:
    n = len(records.get("k", []))
    if n == 0:
        return ["(empty ring)"]
    rows = ["| k | event | i_star | lam | gap | objective | step_inf | stall |",
            "|---|---|---|---|---|---|---|---|"]
    take = np.unique(
        np.linspace(0, n - 1, min(n, _CURVE_ROWS)).astype(int)
    )
    for t in take:
        ev = int(records["event"][t])
        name = (
            obs_telemetry.EVENT_NAMES[ev]
            if 0 <= ev < len(obs_telemetry.EVENT_NAMES) else str(ev)
        )
        rows.append(
            "| " + " | ".join(
                _fmt(v) for v in (
                    records["k"][t], name, records["i_star"][t],
                    float(records["lam"][t]), float(records["gap"][t]),
                    float(records["objective"][t]),
                    float(records["step_inf"][t]), records["stall"][t],
                )
            ) + " |"
        )
    return rows


def render_markdown(report: Dict) -> str:
    """The human-facing artifact: provenance, per-run convergence curve,
    dots-per-backend table, span time breakdown, counter table."""
    lines = ["# Solver run report", ""]
    lines.append("## Provenance")
    for k, v in report.get("meta", {}).items():
        lines.append(f"- **{k}**: {_fmt(v)}")
    lines.append("")

    runs = report.get("runs", [])
    if runs:
        lines.append("## Runs (dots per backend)")
        lines.append(
            "| run | backend | iterations | n_dots | objective | gap "
            "| seconds | comm fraction |"
        )
        lines.append("|---|---|---|---|---|---|---|---|")
        for run in runs:
            lines.append(
                "| " + " | ".join(
                    _fmt(run.get(k)) for k in (
                        "name", "backend", "iterations", "n_dots",
                        "objective", "gap", "seconds", "comm_fraction",
                    )
                ) + " |"
            )
        lines.append("")
    for run in runs:
        if "records" not in run:
            continue
        lines.append(f"## Convergence curve — {run.get('name', '?')}")
        if run.get("event_counts"):
            lines.append(
                "step events: " + ", ".join(
                    f"{k}={v}" for k, v in run["event_counts"].items()
                )
            )
            lines.append("")
        lines.extend(_curve_table(run["records"]))
        lines.append("")

    spans = report.get("spans")
    if spans:
        lines.append("## Time breakdown (host spans)")
        lines.append("| span | count | total s | mean s |")
        lines.append("|---|---|---|---|")
        for name in sorted(spans, key=lambda n: -spans[n]["total_s"]):
            row = spans[name]
            lines.append(
                f"| {name} | {row['count']} | {row['total_s']:.4f} "
                f"| {row['mean_s']:.4f} |"
            )
        lines.append("")
    counters = report.get("counters")
    if counters:
        lines.append("## Counters")
        lines.append("| counter | value |")
        lines.append("|---|---|")
        for name in sorted(counters):
            lines.append(f"| {name} | {_fmt(counters[name])} |")
        lines.append("")
    return "\n".join(lines)


def write_report(out_dir, report: Dict, name: str = "solver_report") -> Dict[str, str]:
    """Write ``<name>.json`` + ``<name>.md`` under ``out_dir``; returns
    the paths."""
    os.makedirs(out_dir, exist_ok=True)
    json_path = os.path.join(out_dir, f"{name}.json")
    md_path = os.path.join(out_dir, f"{name}.md")
    with open(json_path, "wt") as fh:
        json.dump(report, fh, indent=2)
    with open(md_path, "wt") as fh:
        fh.write(render_markdown(report))
    return {"json": json_path, "markdown": md_path}
