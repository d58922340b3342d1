"""Blaze core: JSON Schema -> validation DSL compiler + executors.

Schema compilation (compiler.py), the validation DSL (instructions.py),
the sequential fail-fast executor (executor.py), the tensor tape
(tape.py) and the batched executor in PyTorch (batch_executor.py, imported
on its own so that the front end loads without torch).
"""

from .compiler import CompiledSchema, CompilerOptions, compile_schema
from .executor import Validator
from .doc_model import parse_document
from .outcomes import (
    BreakerConfig,
    CircuitBreaker,
    DocumentDepthError,
    GuardLimits,
    InjectedFault,
    ValidationBudget,
    ValidationOutcome,
    ValidationTimeout,
    Verdict,
    fault_point,
    resource_guard,
    set_fault_hook,
)
from .schema_resolver import Dialect

__all__ = [
    "CompiledSchema",
    "CompilerOptions",
    "compile_schema",
    "Validator",
    "parse_document",
    "Dialect",
    "BreakerConfig",
    "CircuitBreaker",
    "DocumentDepthError",
    "GuardLimits",
    "InjectedFault",
    "ValidationBudget",
    "ValidationOutcome",
    "ValidationTimeout",
    "Verdict",
    "fault_point",
    "resource_guard",
    "set_fault_hook",
]
