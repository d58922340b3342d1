"""The JAX package's own differential suite (``test_differential.py``),
run against the port on the CPU: the compiled engine against the
interpreter on Hypothesis schemas and documents, and the empty and false
schemas.  Its two left-out tests and their reasons are in
``torch_suites.LEFT_OUT``.
"""

from torch_suites import expose, load_adapted

globals().update(expose(load_adapted("test_differential.py", "cpu")))
