"""The JAX package's own batched-executor suites, run against the port on
the CPU: the CSR executor (``test_batch_csr.py``), the executor's
Hypothesis differential (``test_batch_executor.py``) and recursion
unrolling with its frontier sentinel (``test_recursive_unroll.py``).

Each suite is the reference's text with the declared, counted
substitutions of ``torch_suites.adapted_suites("cpu")``; every test it
defines is collected from here.  The same suites run on the card from
``test_torch_cuda_suites.py``.
"""

import re

import pytest

from torch_suites import (TESTS, LEFT_OUT, adapt_suite, adapted_suites, expose,
                          load_adapted)

_csr = load_adapted("test_batch_csr.py", "cpu")
_executor = load_adapted("test_batch_executor.py", "cpu")
_unroll = load_adapted("test_recursive_unroll.py", "cpu")

globals().update(expose(_csr))
globals().update(expose(_executor))
globals().update(expose(_unroll))

_JAX = re.compile(r"import jax|\bjax\.|\bjnp\.")
# the reference's switch between its jnp path and its Pallas kernels, which
# the port replaces by a device
_PALLAS = re.compile(r"use_pallas=(True|False)|\.use_pallas\b")


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("name", sorted(adapted_suites("cpu")))
def test_adapted_suite_is_free_of_jax(name, device):
    """The machine with the card has no JAX: no adapted text of the
    executor and registry suites imports or uses it or the Pallas switch,
    nothing it defines comes from the JAX package, and every left-out test
    has its reason."""
    adapted = adapt_suite((TESTS / name).read_text(), adapted_suites(device)[name])
    assert not _JAX.findall(adapted) and not _PALLAS.findall(adapted)
    module = load_adapted(name, device)
    for value in vars(module).values():
        owner = getattr(value, "__module__", "") or ""
        assert owner.split(".")[0] not in ("repro", "jax"), (name, value)
    assert all(LEFT_OUT.get(name, {}).values())
