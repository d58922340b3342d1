"""Helpers that run the JAX package's own test suites against the port.

Not collected.  A suite is the reference test file's text with declared
substitutions, each one counted: imports from ``repro_torch`` instead of
``repro``, a ``device`` where the reference picks a path with
``use_pallas`` or builds a registry with its default, and little else.
Everything else -- inputs, fuzzers, assertions -- is the reference's, so a
suite follows the reference when it changes.

``adapted_suites(device)`` adapts the executor and registry suites and the
conformance corpus gate to the CPU (``"cpu"``, collected by
``test_torch_suites_*.py`` and ``test_torch_conformance.py``) or to the card
(``"cuda"``, collected by ``test_torch_cuda_suites.py``).  Where the
reference holds its jnp path against its Pallas kernels on the same input,
the jnp side runs on the CPU in both variants, so on the card that check
becomes the CPU against the card.  The machine with the card has no JAX:
no adapted text of these suites imports or uses it.
"""

import sys
import types
from pathlib import Path

TESTS = Path(__file__).resolve().parent

IMPORTS = ("from repro.", "from repro_torch.")
GENERATOR = ("init(jax.random.PRNGKey(0))", "init(torch.Generator().manual_seed(0))")

# each variant's module names, so a suite loaded for the CPU and for the
# card are two modules
PREFIX = {"cpu": "torch_suite_", "cuda": "torch_cuda_suite_"}

# tests of the adapted suites that are not collected, each with its reason
LEFT_OUT = {
    "test_differential.py": {
        "test_failure_sites_match_sequential_trace":
            "the reference fails it too (ROADMAP 3.6): its batched attribution differs "
            "from the sequential trace on some schemas",
        "test_optimizations_preserve_semantics":
            "it runs only the compiler, a byte-identical copy, and its Hypothesis "
            "counterexample (ROADMAP 3.12) turns up in some runs only",
    },
}


def adapt_suite(text: str, subs) -> str:
    """``text`` with each ``(old, new, count)`` substitution applied, where
    ``old`` must occur exactly ``count`` times."""
    for old, new, count in subs:
        assert text.count(old) == count, f"{old!r}: {text.count(old)} occurrences, want {count}"
        text = text.replace(old, new)
    return text


def load_suite(name: str, subs, prefix: str = PREFIX["cpu"]) -> types.ModuleType:
    """The reference suite ``tests/<name>`` adapted to the port, as a module
    registered as ``<prefix><stem>`` (loaded once a process)."""
    module_name = f"{prefix}{Path(name).stem}"
    if module_name in sys.modules:
        return sys.modules[module_name]
    text = adapt_suite((TESTS / name).read_text(), subs)
    module = types.ModuleType(module_name)
    module.__file__ = str(TESTS / name)
    sys.modules[module_name] = module
    try:
        exec(compile(text, f"{name} (adapted to repro_torch)", "exec"), module.__dict__)
    except BaseException:
        del sys.modules[module_name]
        raise
    return module


def adapted_suites(device: str) -> dict:
    """The substitutions that adapt the executor and registry suites and the
    corpus gate to the port on ``device`` (``"cpu"`` or ``"cuda"``), by
    suite file."""
    on = f'device="{device}"'
    cpu = 'device="cpu"'
    csr = ("from test_batch_csr import", f"from {PREFIX[device]}test_batch_csr import", 1)
    card = device == "cuda"
    return {
        "test_batch_csr.py": [
            (*IMPORTS, 4),
            # the jnp side of TestDifferentialFuzz.test_csr_pallas_matches_jnp
            ("tape, max_depth=8, use_pallas=False).validate(table)",
             f"tape, max_depth=8, {cpu}).validate(table)", 1),
            ("use_pallas=False", on, 8),
            ("use_pallas=True", on, 1),
        ],
        "test_batch_executor.py": [
            (*IMPORTS, 4),
            # the jnp side of test_batch_pallas_path_matches_jnp
            ("v1, _ = BatchValidator(tape, max_depth=8, use_pallas=False)",
             f"v1, _ = BatchValidator(tape, max_depth=8, {cpu})", 1),
            ("use_pallas=False", on, 1),
            ("use_pallas=True", on, 1),
        ],
        "test_recursive_unroll.py": [
            (*IMPORTS, 6),
            # the csr base of test_csr_dense_pallas_bit_identity
            ('ref = BatchValidator(tape, use_pallas=False, layout="csr")',
             f'ref = BatchValidator(tape, {cpu}, layout="csr")', 1),
            ("use_pallas=False", on, 10),
            ("use_pallas=True", on, 1),
            ("SchemaRegistry(unroll_depth=3)", f"SchemaRegistry({on}, unroll_depth=3)", 1),
        ],
        "test_logical_circuit.py": [
            (*IMPORTS, 6),
            csr,
            # _check: the csr base on the CPU; on the card every check also
            # runs both layouts there (the reference's ("csr", True) only
            # where it asks for the Pallas spot check)
            *([('layouts = [("csr", False), ("dense", False)] + ([("csr", True)] if pallas '
                'else [])',
                'layouts = [("csr", False), ("dense", True), ("csr", True)]', 1),
               ("use_pallas=use_pallas", 'device="cuda" if use_pallas else "cpu"', 1)]
              if card else [("use_pallas=use_pallas", on, 1)]),
            ("use_pallas=False", on, 4),
            ("SchemaRegistry()", f"SchemaRegistry({on})", 1),
        ],
        "test_registry_linker.py": [
            (*IMPORTS, 7),
            csr,
            # the jnp side of test_linked_pallas_matches_jnp
            ("v1, d1 = BatchValidator(linked, use_pallas=False).validate(table, ids)",
             f"v1, d1 = BatchValidator(linked, {cpu}).validate(table, ids)", 1),
            ("use_pallas=False", on, 14),
            ("use_pallas=True", on, 1),
            ("SchemaRegistry()", f"SchemaRegistry({on})", 11),
            ("AdmissionController(deep, ", f"AdmissionController(deep, {on}, ", 2),
            # the port has no use_pallas switch: its validator has a device
            ("assert ctrl.batch_validator.use_pallas is False",
             f'assert ctrl.batch_validator.device.type == "{device}"', 1),
        ],
        "test_differential.py": [
            (*IMPORTS, 4),
            ("use_pallas=False", on, 1),
        ],
        "test_lint_tape.py": [
            (*IMPORTS, 7),
            ("use_pallas=False", on, 1),
            ('main(["--presets", "-q"])', f'main(["--presets", "-q", "--device", "{device}"])', 1),
        ],
        "test_schema_algebra.py": [
            (*IMPORTS, 11),
            ("use_pallas=False", on, 10),
            ("    import jax\n", "    import torch\n", 1),
            (GENERATOR[0], f'init(torch.Generator("{device}").manual_seed(0))', 1),
            ("default_max_tokens=4)\n    )", f"default_max_tokens=4), {on}\n    )", 1),
            ("build_report()", f"build_report({on})", 1),
        ],
        # the tier-1 corpus gate, pointed at the port's runner, in both layouts
        "test_conformance_corpus.py": [
            ("from pathlib import Path\n", "from pathlib import Path\n\nimport pytest\n", 1),
            ('ROOT / "scripts" / "conformance.py"',
             'ROOT / "src" / "repro_torch" / "launch" / "conformance.py"', 1),
            ("def test_corpus_all_engines_agree():\n",
             '@pytest.mark.parametrize("layout", ["csr", "dense"])\n'
             "def test_corpus_all_engines_agree(layout):\n", 1),
            ("runner.run_corpus()", f"runner.run_corpus({on}, layout=layout)", 1),
        ],
    }


# the suites an adapted suite imports helpers from, loaded before it
_NEEDS = {"test_logical_circuit.py": "test_batch_csr.py",
          "test_registry_linker.py": "test_batch_csr.py"}


def load_adapted(name: str, device: str) -> types.ModuleType:
    """The suite ``tests/<name>`` of ``adapted_suites`` adapted to ``device``."""
    subs = adapted_suites(device)
    if name in _NEEDS:
        load_suite(_NEEDS[name], subs[_NEEDS[name]], PREFIX[device])
    return load_suite(name, subs[name], PREFIX[device])


def expose(module: types.ModuleType, rename=None) -> dict:
    """The ``Test*`` classes and ``test*`` functions that ``module`` defines,
    less its ``LEFT_OUT`` tests, by the name they are collected under
    (``rename`` maps a reference name to another where two suites collected
    from one file define the same name)."""
    rename = rename or {}
    left_out = LEFT_OUT.get(Path(module.__file__).name, {})
    out = {}
    for name, obj in vars(module).items():
        if getattr(obj, "__module__", None) != module.__name__ or name in left_out:
            continue
        if (isinstance(obj, type) and name.startswith("Test")) or (
                callable(obj) and not isinstance(obj, type) and name.startswith("test")):
            out[rename.get(name, name)] = obj
    missing = set(left_out) - set(vars(module))
    assert not missing, f"left-out tests not in {module.__file__}: {sorted(missing)}"
    return out
