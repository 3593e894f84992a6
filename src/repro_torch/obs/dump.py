"""Summarize a flight-recorder Chrome-trace dump on the command line (port
of ``repro.obs.dump``: the same text for the same document).

::

    python -m repro_torch.obs.dump trace.json

prints per-phase span statistics (count / total / mean / max) and the
discrete-event counts of the dump, so a crash post-mortem is readable
without a browser.  For the full timeline, load the same file at
https://ui.perfetto.dev (or ``chrome://tracing``) — it is standard
Chrome ``trace_event`` JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List


def summarize(doc: Dict[str, Any]) -> str:
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("not a Chrome trace: no traceEvents array")
    spans: Dict[str, List[float]] = {}
    instants: Dict[str, int] = {}
    ticks = 0
    for e in events:
        ph = e.get("ph")
        if ph == "X":
            if e.get("cat") == "tick":
                ticks += 1
            else:
                spans.setdefault(e["name"], []).append(
                    float(e.get("dur", 0.0))
                )
        elif ph == "i":
            instants[e["name"]] = instants.get(e["name"], 0) + 1
    lines = [f"ticks retained: {ticks}"]
    if spans:
        lines.append("phase spans (µs):")
        lines.append(
            f"  {'name':<12} {'count':>6} {'total':>12} "
            f"{'mean':>10} {'max':>10}"
        )
        for name in sorted(spans):
            d = spans[name]
            lines.append(
                f"  {name:<12} {len(d):>6} {sum(d):>12.1f} "
                f"{sum(d) / len(d):>10.1f} {max(d):>10.1f}"
            )
    if instants:
        lines.append("events:")
        for name in sorted(instants):
            lines.append(f"  {name:<16} {instants[name]}")
    lines.append(
        "view the timeline: load this file at https://ui.perfetto.dev"
    )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.dump",
        description="summarize a flight-recorder Chrome-trace dump",
    )
    ap.add_argument("trace", help="path to a flight-recorder dump (.json)")
    args = ap.parse_args(argv)
    try:
        with open(args.trace) as f:
            doc = json.load(f)
        print(summarize(doc))
    except (OSError, ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
