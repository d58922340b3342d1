"""Registry-wide analysis report: the schema-algebra posture artifact.

Runs the register()-time pipeline (DESIGN.md §15) over the gateway
preset schemas and emits one machine-readable JSON tree:

- per-endpoint analysis counters (pruned branches, folded assertions,
  structural-dedup overlap, normalization verdict, analysis wall time)
- link-group layout including the physical ``linked_members`` after
  canonical-hash segment dedup
- tape-lint status for every member and group tape

By default it writes ``results/analysis_report_torch.json``, beside
the JAX package's ``results/analysis_report.json``, which it never
overwrites.

Usage::

    python -m repro_torch.analysis.report [--out results/analysis_report_torch.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from .lint_tape import lint_tape

__all__ = ["build_report", "main"]


def build_report(device=None) -> Dict[str, Any]:
    """Assemble the posture tree over the registry presets (the registry
    on ``device``: cuda unless told otherwise)."""
    from ..registry.presets import GATEWAY_SCHEMAS
    from ..registry.registry import SchemaRegistry

    reg = SchemaRegistry(device=device)
    for name, schema in GATEWAY_SCHEMAS.items():
        reg.register(name, schema)

    endpoints: Dict[str, Any] = {}
    lint_failures: List[str] = []
    for name in GATEWAY_SCHEMAS:
        entry = reg.get(name)
        st = entry.stats
        per: Dict[str, Any] = {
            "version": entry.version,
            "batchable": st.batchable,
            "analysis_seconds": round(st.analysis_seconds, 6),
            "normalized": st.normalized,
            "pruned_branches": st.pruned_branches,
            "folded_assertions": st.folded_assertions,
            "dedup_subgraphs": st.dedup_subgraphs,
            "analysis_failure": st.analysis_failure,
            "canonical_hash": entry.canonical_hash,
            "unroll_depth": st.unroll_depth,
            "a_hat": st.a_hat,
            "horizon": st.horizon,
            "n_circuits": st.n_circuits,
        }
        if entry.analysis is not None:
            per["reasons"] = list(entry.analysis.reasons)
        if entry.tape is not None:
            problems = lint_tape(entry.tape)
            per["lint"] = "ok" if not problems else "FAIL"
            lint_failures += [f"{name}: {p}" for p in problems]
        endpoints[name] = per

    groups: Dict[str, Any] = {}
    for g in reg.groups():
        problems = lint_tape(g.tape)
        groups[g.label] = {
            "members": list(g.members),
            "linked_members": list(g.linked_members),
            "deduped_segments": len(g.members) - len(g.linked_members),
            "a_hat": int(g.tape.max_rows_per_loc),
            "m_hat": int(g.tape.max_member_props),
            "horizon": int(g.tape.max_loc_depth) + 1,
            "lint": "ok" if not problems else "FAIL",
        }
        lint_failures += [f"group {g.label}: {p}" for p in problems]

    return {
        "endpoints": endpoints,
        "groups": groups,
        "swap_verdicts": reg.swap_verdicts(),
        "lint_failures": lint_failures,
        "totals": {
            "pruned_branches": sum(p["pruned_branches"] for p in endpoints.values()),
            "folded_assertions": sum(p["folded_assertions"] for p in endpoints.values()),
            "dedup_subgraphs": sum(p["dedup_subgraphs"] for p in endpoints.values()),
            "normalized_endpoints": sum(1 for p in endpoints.values() if p["normalized"]),
            "analysis_seconds": round(
                sum(p["analysis_seconds"] for p in endpoints.values()), 6
            ),
        },
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.analysis.report", description=__doc__)
    ap.add_argument(
        "--out",
        default="results/analysis_report_torch.json",
        help="output path (default: results/analysis_report_torch.json)",
    )
    ap.add_argument("--device", default="cuda", help="the registry's device: cuda or cpu")
    args = ap.parse_args(argv)
    report = build_report(device=args.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2, sort_keys=True) + "\n")
    t = report["totals"]
    print(
        f"analysis report: {len(report['endpoints'])} endpoints, "
        f"{t['pruned_branches']} pruned, {t['folded_assertions']} folded, "
        f"{t['dedup_subgraphs']} dedup overlaps -> {out}"
    )
    if report["lint_failures"]:
        for f in report["lint_failures"]:
            print(f"  LINT {f}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
