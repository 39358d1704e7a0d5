"""CLI lint runner:

    python -m repro_torch.analysis <artifact-or-bundle>...

Exit codes: 0 all subjects clean of unsuppressed errors; 1 at least one
unsuppressed error (or, with ``--strict``, any unsuppressed diagnostic);
2 a path could not be analyzed at all (unreadable / not an artifact).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static schedule sanitizer for compiled deployments: "
        "race/interference, scratchpad lifetime, and WCET-soundness rules "
        "over .rtdep artifacts and bundle directories.",
    )
    ap.add_argument(
        "paths",
        nargs="*",
        help=".rtdep artifact files and/or bundle directories",
    )
    ap.add_argument(
        "--suppress",
        action="append",
        default=[],
        metavar="RULE[@scope]",
        help="waive a rule, optionally scoped to an op / s<sid> / "
        "core<n> / network (repeatable)",
    )
    ap.add_argument(
        "--strict",
        action="store_true",
        help="fail on any unsuppressed diagnostic, warnings included",
    )
    ap.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule catalog and exit",
    )
    args = ap.parse_args(argv)

    from .diagnostics import RULES

    if args.list_rules:
        for r in RULES.values():
            print(f"{r.rule_id:<9} {r.severity:<8} {r.family:<11} {r.title}")
        return 0
    if not args.paths:
        ap.error("no artifacts given (pass .rtdep files or bundle dirs)")

    from ..compiler.deployment import ArtifactError
    from .runner import (
        analyze_artifact,
        analyze_bundle,
        analyze_cluster,
        is_cluster_artifact,
    )

    suppress = tuple(args.suppress)
    failed = False
    broken = False
    for path in args.paths:
        try:
            if os.path.isdir(path) and is_cluster_artifact(path):
                reports = analyze_cluster(path, suppress=suppress)
            elif os.path.isdir(path):
                reports = analyze_bundle(path, suppress=suppress)
            else:
                reports = [analyze_artifact(path, suppress=suppress)]
        except (ArtifactError, OSError, ValueError) as e:
            # ValueError covers zipfile.BadZipFile / pickle garbage from
            # files that are not artifacts at all; OSError covers missing
            # or unreadable paths.
            msg = str(e)
            if path not in msg:
                msg = f"{path}: {msg}"
            print(f"error: {msg}", file=sys.stderr)
            broken = True
            continue
        for rep in reports:
            print(rep.summary())
            if not rep.ok or (args.strict and rep.unsuppressed()):
                failed = True
    if broken:
        return 2
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
