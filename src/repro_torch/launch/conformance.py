#!/usr/bin/env python
"""JSON-Schema-Test-Suite-style conformance corpus runner.

Loads the vendored case files under ``tests/conformance/`` (the official
suite's format: a list of groups, each ``{description, schema, tests:
[{description, data, valid}]}``) and runs every case through all four
engines:

* ``naive``        -- NaiveValidator (direct schema interpretation)
* ``interpreter``  -- compiled instruction interpreter (paper §5)
* ``codegen``      -- compiled closure engine
* ``batched``      -- the tensorised tape executor where the schema is
  batchable (hybrid contract: undecided documents route to the
  sequential verdict; unbatchable schemas count as ``skipped``)

Writes a pass/fail summary to ``results/conformance_summary_torch.json``
(never the JAX package's ``results/conformance_summary.json``) and exits
non-zero if any engine disagrees with a corpus expectation.  The batched
engine runs on ``--device`` (cuda unless told otherwise):

    python -m repro_torch.launch.conformance --device cpu|cuda
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]  # src/repro_torch/launch/ -> the repo
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import NaiveValidator, Validator, compile_schema  # noqa: E402
from repro_torch.core.batch_executor import BatchValidator, resolve_device  # noqa: E402
from repro_torch.core.tape import try_build_tape  # noqa: E402
from repro_torch.data.doc_table import encode_batch  # noqa: E402

CORPUS = ROOT / "tests" / "conformance"
RESULTS = ROOT / "results"

ENGINES = ("naive", "interpreter", "codegen", "batched")


def run_corpus(device=None, layout="csr") -> dict:
    """Every corpus case through the four engines, the batched one on
    ``device`` (cuda unless told otherwise: without CUDA it raises) in
    ``layout``."""
    device = resolve_device(device)
    summary = {
        "files": {},
        "totals": {e: {"passed": 0, "failed": 0, "skipped": 0} for e in ENGINES},
        "failures": [],
    }
    for path in sorted(CORPUS.glob("*.json")):
        file_stats = {e: {"passed": 0, "failed": 0, "skipped": 0} for e in ENGINES}
        for group in json.loads(path.read_text()):
            schema = group["schema"]
            naive = NaiveValidator(schema)
            compiled = compile_schema(schema)
            interp = Validator(compiled, engine="interpreter")
            codegen = Validator(compiled, engine="codegen")
            tape, _reason = try_build_tape(compiled)
            batch = (
                BatchValidator(tape, device=device, layout=layout) if tape is not None else None
            )
            for test in group["tests"]:
                doc, expected = test["data"], test["valid"]
                verdicts = {
                    "naive": naive.is_valid(doc),
                    "interpreter": interp.is_valid(doc),
                    "codegen": codegen.is_valid(doc),
                }
                if batch is None:
                    verdicts["batched"] = None  # skipped: outside the subset
                else:
                    table = encode_batch([doc], max_nodes=128, max_depth=16)
                    valid, decided = batch.validate(table)
                    # hybrid contract: undecided rows get the sequential verdict
                    verdicts["batched"] = (
                        bool(valid[0]) if decided[0] else interp.is_valid(doc)
                    )
                for engine in ENGINES:
                    got = verdicts[engine]
                    if got is None:
                        file_stats[engine]["skipped"] += 1
                    elif got is expected:
                        file_stats[engine]["passed"] += 1
                    else:
                        file_stats[engine]["failed"] += 1
                        summary["failures"].append(
                            {
                                "file": path.name,
                                "group": group["description"],
                                "test": test["description"],
                                "engine": engine,
                                "expected": expected,
                                "got": got,
                            }
                        )
        summary["files"][path.name] = file_stats
        for engine in ENGINES:
            for k in ("passed", "failed", "skipped"):
                summary["totals"][engine][k] += file_stats[engine][k]
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.conformance")
    ap.add_argument("--device", default="cuda", help="the batched engine's device: cuda or cpu")
    args = ap.parse_args(argv)
    summary = run_corpus(device=args.device)
    RESULTS.mkdir(exist_ok=True)
    out = RESULTS / "conformance_summary_torch.json"
    out.write_text(json.dumps(summary, indent=1) + "\n")
    for engine, tot in summary["totals"].items():
        print(
            f"{engine:12s} passed={tot['passed']:4d} failed={tot['failed']:3d} "
            f"skipped={tot['skipped']:3d}"
        )
    if summary["failures"]:
        print(f"\n{len(summary['failures'])} failure(s); first 20:")
        for f in summary["failures"][:20]:
            print(f"  [{f['engine']}] {f['file']} :: {f['group']} :: {f['test']} "
                  f"expected={f['expected']} got={f['got']}")
        return 1
    print(f"\nOK -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
