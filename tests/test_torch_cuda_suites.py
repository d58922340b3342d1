"""The JAX package's own executor and registry suites on the card (marker
``cuda``).

Skipped without a GPU.  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py tests/test_torch_cuda_suites.py

The suites that ``test_torch_suites_{executor,registry,differential}.py``
and ``test_torch_conformance.py`` run on the CPU, adapted by
``torch_suites.adapted_suites("cuda")``: every executor and registry built
on the card, so the suites' fuzzers, circuits, unrolled recursion, linked
tapes and the registry's fallback routing go through the three CUDA kernels
and the executor's torch glue on CUDA tensors.  Where the reference holds
its jnp path against its Pallas kernels on the same input, the jnp side
runs on the CPU, so that check holds the CPU against the card.  Nothing
here imports JAX: the machine with the card has none.
"""

import pytest
import torch

from torch_suites import adapted_suites, expose, load_adapted

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    """Every test of this file needs the card: decided per test, never while
    the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# two suites define a TestDifferentialFuzz: the circuits' is collected here
# under another name
_RENAME = {"test_logical_circuit.py": {"TestDifferentialFuzz": "TestCircuitDifferentialFuzz"}}

for _name in adapted_suites("cuda"):
    _tests = expose(load_adapted(_name, "cuda"), rename=_RENAME.get(_name))
    assert not set(_tests) & set(globals()), (_name, set(_tests) & set(globals()))
    globals().update(_tests)
