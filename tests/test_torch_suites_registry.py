"""The JAX package's own registry suites, run against the port on the CPU:
logical circuits (``test_logical_circuit.py``), the linker, the registry
and link groups (``test_registry_linker.py``), the tape linter
(``test_lint_tape.py``) and the schema algebra with its hot-swap verdicts
(``test_schema_algebra.py``).

Each suite is the reference's text with the declared, counted
substitutions of ``torch_suites.adapted_suites("cpu")``; every test it
defines is collected from here.  The same suites run on the card from
``test_torch_cuda_suites.py``.
"""

from torch_suites import expose, load_adapted

globals().update(expose(load_adapted("test_logical_circuit.py", "cpu")))
globals().update(expose(load_adapted("test_registry_linker.py", "cpu")))
globals().update(expose(load_adapted("test_lint_tape.py", "cpu")))
globals().update(expose(load_adapted("test_schema_algebra.py", "cpu")))
