"""The port stands alone: no JAX, nothing of ``repro``, faithful copies.

- ``repro_torch`` imports, builds a linked tape and validates on the CPU in
  a process where ``jax`` and ``repro`` cannot be imported;
- an AST scan finds no import of either in ``src/repro_torch`` or
  ``chip_smoke.py``;
- entry points default to CUDA and raise without it;
- the port's copy of the front end (compiler, tape builder, linker,
  encoder) gives the reference's arrays exactly, and the copied modules are
  the reference's sources.
"""

import ast
import dataclasses
import importlib
import inspect
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import compile_schema as ref_compile
from repro.core.tape import try_build_tape as ref_try_build
from repro.data.doc_table import encode_batch as ref_encode
from repro.registry.linker import link_tapes as ref_link
from repro_torch.core import compile_schema
from repro_torch.core.batch_executor import BatchValidator
from repro_torch.core.tape import try_build_tape
from repro_torch.data.doc_table import encode_batch
from repro_torch.registry import link_tapes
from repro_torch.registry.presets import GATEWAY_SCHEMAS

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

# modules carried over unchanged (all their imports are package-relative)
COPIED = [
    "core/nodetypes.py", "core/hashing.py", "core/json_pointer.py", "core/regex_opt.py",
    "core/schema_resolver.py", "core/instructions.py", "core/compiler.py",
    "core/doc_model.py", "core/outcomes.py", "core/explain.py", "core/executor.py",
    "core/codegen.py", "core/tape.py", "data/doc_table.py", "obs/profile.py",
    "obs/trace.py", "obs/metrics.py", "registry/linker.py", "registry/presets.py",
    "core/interpreter.py", "analysis/structhash.py", "analysis/sat.py",
    "analysis/subsume.py", "analysis/normalize.py", "analysis/unroll.py",
    "obs/stats.py", "data/tokenizer.py",
]


def test_imports_and_runs_without_jax_or_repro():
    script = textwrap.dedent(
        """
        import pkgutil, sys
        sys.modules["jax"] = None      # any import of jax now raises
        sys.modules["repro"] = None    # and so does any import of the JAX package
        import repro_torch
        for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            __import__(info.name)
        from repro_torch.core import compile_schema
        from repro_torch.core.batch_executor import BatchValidator
        from repro_torch.core.tape import try_build_tape
        from repro_torch.data.doc_table import encode_batch
        from repro_torch.registry import link_tapes
        from repro_torch.registry.presets import GATEWAY_SCHEMAS
        names = list(GATEWAY_SCHEMAS)
        tape = link_tapes([try_build_tape(compile_schema(GATEWAY_SCHEMAS[n]))[0]
                           for n in names], names=names)
        table = encode_batch([{"prompt": "hi"}, {"prompt": ""}], max_nodes=16)
        valid, decided, _ = BatchValidator(tape, device="cpu").validate_ex(table, [0, 0])
        assert valid.tolist() == [True, False] and decided.all()
        loaded = [m for m, mod in sys.modules.items()
                  if mod is not None and m.split(".")[0] in ("jax", "repro")]
        assert not loaded, loaded
        print("standalone ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_LINT_TAPES="1")
    out = subprocess.run(
        [sys.executable, "-c", script], env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert "standalone ok" in out.stdout


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    # a relative import may climb at most to the top of the port's package
    max_level = len(path.relative_to(PORT).parts) if PORT in path.parents else 0
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level <= max_level, f"{path}: {ast.dump(node)}"
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_entry_point_defaults_to_cuda_and_raises_without_it(monkeypatch):
    tape, _ = try_build_tape(compile_schema({"type": "integer"}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchValidator(tape)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchValidator(tape, device="cuda")
    assert BatchValidator(tape, device="cpu").device.type == "cpu"
    assert BatchValidator(tape, device="cpu", layout="dense").layout == "dense"


def _assert_fields_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", list(GATEWAY_SCHEMAS))
def test_copied_front_end_builds_the_reference_tape(name):
    got, why = try_build_tape(compile_schema(GATEWAY_SCHEMAS[name]))
    want, _ = ref_try_build(ref_compile(GATEWAY_SCHEMAS[name]))
    assert got is not None, why
    _assert_fields_equal(got, want)


def test_copied_linker_and_encoder_match_the_reference():
    names = list(GATEWAY_SCHEMAS)
    got = link_tapes([try_build_tape(compile_schema(GATEWAY_SCHEMAS[n]))[0] for n in names],
                     names=names)
    want = ref_link([ref_try_build(ref_compile(GATEWAY_SCHEMAS[n]))[0] for n in names],
                    names=names)
    _assert_fields_equal(got, want)
    docs = [{"prompt": "héllo " * 9, "max_tokens": 3, "temperature": 0.25},
            {"messages": [{"role": "user", "content": "hi"}], "stop": [None, True, 1.5]},
            "x" * 40, [[[]]], {"deep": [{"a": {"b": [1, 2, {"c": None}]}}]}]
    _assert_fields_equal(encode_batch(docs, max_nodes=16, max_depth=4),
                         ref_encode(docs, max_nodes=16, max_depth=4))


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_is_the_reference_source(rel):
    assert (PORT / rel).read_text() == (REF / rel).read_text()


def test_lint_tape_copy_keeps_the_checks():
    # the package __init__ re-exports a function named like the module
    port_lint = importlib.import_module("repro_torch.analysis.lint_tape")
    ref_lint = importlib.import_module("repro.analysis.lint_tape")
    assert not hasattr(port_lint, "main")  # the CLI needs the registry
    for fn in ("lint_tape", "assert_tape"):
        assert inspect.getsource(getattr(port_lint, fn)) == inspect.getsource(
            getattr(ref_lint, fn)
        )
