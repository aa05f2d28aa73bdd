"""pintlint reporters: text for humans/CI logs, JSON for bench
telemetry and tooling."""

from __future__ import annotations

import json

from .core import counts_by_rule, unsuppressed


def text_report(findings, show_suppressed=False):
    lines = []
    shown = findings if show_suppressed else unsuppressed(findings)
    for f in shown:
        lines.append(str(f))
    live = unsuppressed(findings)
    n_sup = len(findings) - len(live)
    summary = (f"pintlint: {len(live)} finding(s), "
               f"{n_sup} suppressed")
    counts = counts_by_rule(findings)
    if counts:
        summary += " [" + ", ".join(f"{k}={v}"
                                    for k, v in counts.items()) + "]"
    lines.append(summary)
    return "\n".join(lines)


def json_report(findings):
    live = unsuppressed(findings)
    return json.dumps({
        "findings": [f.as_dict() for f in findings],
        "unsuppressed": len(live),
        "suppressed": len(findings) - len(live),
        "counts_by_rule": counts_by_rule(findings),
    }, indent=2, sort_keys=True)
