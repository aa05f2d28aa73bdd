"""CLI: ``python -m pint_tpu_torch.analysis [paths...]``.

Exit status 0 when every finding is suppressed (each suppression is a
reviewed, justified exception), 1 when unsuppressed findings remain,
2 on usage errors. ``--format json`` emits the machine report.

Two speeds:

- the default run includes the whole-program pass (ProjectIndex +
  lock-order-cycle / precision-flow / signature-incomplete /
  registry-drift) — the CI gate;
- ``--changed`` lints only files touched in the git diff (``--cached``
  for the staged set) and skips whole-program rules, keeping the inner
  edit loop fast.

``--lock-dag PATH`` writes the acquired-while-held lock-order graph as
JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from . import (LintConfig, all_rules, json_report, run_project,
               text_report, unsuppressed)


def _list_rules():
    lines = []
    for rule in all_rules():
        tag = " (whole-program)" if rule.whole_program else ""
        lines.append(f"{rule.id:24s} [{rule.family}]{tag} "
                     f"{rule.rationale}")
    return "\n".join(lines)


def _changed_files(cached=False):
    """Python files touched in the git diff, absolute paths."""
    top = subprocess.run(
        ["git", "rev-parse", "--show-toplevel"],
        capture_output=True, text=True)
    if top.returncode != 0:
        raise SystemExit("pintlint: --changed requires a git checkout "
                         f"({top.stderr.strip()})")
    root = top.stdout.strip()
    cmd = ["git", "diff", "--name-only", "--diff-filter=ACMR"]
    cmd.append("--cached" if cached else "HEAD")
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
    if out.returncode != 0:
        raise SystemExit(f"pintlint: git diff failed: "
                         f"{out.stderr.strip()}")
    files = []
    for line in out.stdout.splitlines():
        if not line.endswith(".py"):
            continue
        path = os.path.join(root, line)
        if os.path.exists(path):
            files.append(path)
    return files


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="pintlint",
        description="pint_tpu_torch codebase-aware static analysis")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files or directories to lint "
                             "(default: the pint_tpu_torch package)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="include suppressed findings in text "
                             "output")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("--changed", action="store_true",
                        help="lint only .py files in the git diff "
                             "(per-file rules only — the whole-"
                             "program pass is skipped)")
    parser.add_argument("--cached", action="store_true",
                        help="with --changed: diff the staged set "
                             "(pre-commit mode)")
    parser.add_argument("--no-whole-program", action="store_true",
                        help="skip the ProjectIndex pass and every "
                             "whole-program rule")
    parser.add_argument("--lock-dag", metavar="PATH",
                        help="write the lock-order graph (JSON) here")
    args = parser.parse_args(argv)
    if args.list_rules:
        print(_list_rules())
        return 0
    whole_program = not args.no_whole_program
    paths = args.paths
    if args.changed:
        if paths:
            parser.error("--changed and explicit paths are exclusive")
        paths = _changed_files(cached=args.cached)
        whole_program = False
        if not paths:
            print("pintlint: no changed python files")
            return 0
    if not paths:
        import pint_tpu_torch

        paths = [pint_tpu_torch.__path__[0]]
    findings, project = run_project(paths, config=LintConfig.default(),
                                    whole_program=whole_program)
    if args.lock_dag:
        graph = project.lock_graph
        payload = (graph.as_dict() if graph is not None
                   else {"nodes": [], "edges": []})
        with open(args.lock_dag, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")
    if args.format == "json":
        print(json_report(findings))
    else:
        print(text_report(findings,
                          show_suppressed=args.show_suppressed))
    return 1 if unsuppressed(findings) else 0


if __name__ == "__main__":
    sys.exit(main())
