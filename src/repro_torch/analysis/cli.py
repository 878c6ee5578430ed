"""CLI driver: load sources, run every rule, apply suppressions.

Exit status: 0 when the tree is clean (suppressed findings are fine and
are reported as documentation), 1 on any unsuppressed finding or
parse/grammar error.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.core import Finding, Project, load_project


def _rules():
    from repro_torch.analysis import ALL_RULES   # late: avoids a module cycle
    return ALL_RULES


def _apply_suppressions(project: Project, findings: List[Finding],
                        token_by_rule) -> None:
    by_rel = {f.rel: f for f in project.files}
    for fd in findings:
        token = token_by_rule.get(fd.rule)
        src = by_rel.get(fd.path)
        if token is None or src is None:
            continue   # grammar/parse findings are never suppressible
        for line in (fd.line, fd.line - 1):
            reason = src.suppressions.get(line, {}).get(token)
            if reason:
                fd.suppressed = True
                fd.reason = reason
                break


def run_paths(paths: Sequence[str], base: Optional[Path] = None
              ) -> Tuple[List[Finding], List[Finding]]:
    """Run every registered rule.  Returns (unsuppressed, suppressed)."""
    rules = _rules()
    project, findings = load_project(paths, (r.token for r in rules),
                                     base=base)
    for rule in rules:
        findings.extend(rule.check(project))
    _apply_suppressions(project, findings, {r.id: r.token for r in rules})
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    open_ = [f for f in findings if not f.suppressed]
    closed = [f for f in findings if f.suppressed]
    return open_, closed


def _finding_key(f) -> Tuple[str, str, str]:
    """Identity of a finding across runs: line numbers shift with
    unrelated edits, so the diff matches on (rule, path, message)."""
    rule = f.rule if hasattr(f, "rule") else f["rule"]
    path = f.path if hasattr(f, "path") else f["path"]
    message = f.message if hasattr(f, "message") else f["message"]
    return (rule, path, message)


def diff_baseline(open_: List[Finding], baseline_path: str
                  ) -> Tuple[List[Finding], int]:
    """Split the open findings against a previous ``--format=json``
    report.  Returns ``(new_findings, resolved_count)``: findings absent
    from the baseline, and baseline findings no longer present."""
    payload = json.loads(Path(baseline_path).read_text())
    known = {_finding_key(f) for f in payload.get("findings", [])}
    new = [f for f in open_ if _finding_key(f) not in known]
    resolved = len(known - {_finding_key(f) for f in open_})
    return new, resolved


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-specific static analysis "
                    "(host-sync, clock-accounting, units, kernel-contract, "
                    "ownership, determinism)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files/directories to scan "
                         "(default: src/repro_torch)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print documented (suppressed) findings")
    ap.add_argument("--baseline", metavar="JSON",
                    help="previous --format=json report: only findings "
                         "NOT in it are reported/counted (diff mode); "
                         "exit 0 when no new findings")
    args = ap.parse_args(argv)

    open_, closed = run_paths(args.paths)
    resolved = None
    if args.baseline:
        open_, resolved = diff_baseline(open_, args.baseline)
    if args.format == "json":
        payload = {
            "findings": [f.to_json() for f in open_],
            "suppressed": [f.to_json() for f in closed],
            "counts": {"open": len(open_), "suppressed": len(closed)},
        }
        if resolved is not None:
            payload["baseline"] = {"new": len(open_), "resolved": resolved}
        print(json.dumps(payload, indent=1, sort_keys=True))
    else:
        for f in open_:
            print(f.render())
        if args.show_suppressed:
            for f in closed:
                print(f.render())
        if resolved is not None:
            print(f"# {len(open_)} new finding(s) vs baseline "
                  f"({resolved} resolved), {len(closed)} suppressed",
                  file=sys.stderr)
        else:
            print(f"# {len(open_)} finding(s), {len(closed)} suppressed",
                  file=sys.stderr)
    return 1 if open_ else 0
