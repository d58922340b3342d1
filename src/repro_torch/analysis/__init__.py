"""Static analysis of tapes: the tape-invariant linter (DESIGN.md §15).

``build_tape`` and ``link_tapes`` call :func:`assert_tape` when
``REPRO_LINT_TAPES`` is set.
"""

from .lint_tape import TapeLintError, assert_tape, lint_tape

__all__ = ["TapeLintError", "assert_tape", "lint_tape"]
