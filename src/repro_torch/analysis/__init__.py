"""Ahead-of-time schema algebra (DESIGN.md §15).

Static-analysis passes that run between schema submission and tape
build, at ``register()`` time:

- :mod:`.structhash` -- canonical serialization + structural hashing,
  used for subgraph dedup across registry members;
- :mod:`.sat` -- conservative satisfiability summaries that back every
  prune *proof*;
- :mod:`.normalize` -- the canonicalizer/normalizer pass pipeline,
  differentially verified against :class:`NaiveValidator`;
- :mod:`.subsume` -- inclusion/equivalence prover between endpoint
  versions (equivalence -> metadata-only hot swap);
- :mod:`.unroll` -- per-schema ``unroll_depth`` sizing;
- :mod:`.lint_tape` -- post-build static checker for
  LocationTape/LinkedTape invariants (``build_tape`` and ``link_tapes``
  call :func:`assert_tape` when ``REPRO_LINT_TAPES`` is set).

All of them are pure Python, copied unchanged from the JAX package.
"""

from .normalize import AnalysisReport, analyze_schema
from .structhash import structural_hash, subschema_hashes
from .subsume import SubsumptionResult, compare
from .unroll import recommend_unroll_depth
from .lint_tape import TapeLintError, assert_tape, lint_tape

__all__ = [
    "AnalysisReport",
    "analyze_schema",
    "structural_hash",
    "subschema_hashes",
    "SubsumptionResult",
    "compare",
    "recommend_unroll_depth",
    "TapeLintError",
    "assert_tape",
    "lint_tape",
]
