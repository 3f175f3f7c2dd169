"""Nothing the benchmark runs imports JAX or the JAX package, and the
references import nothing of the program. Modules are compared by their
top-level name whole: `mpas_tpu_torch` begins with `mpas_tpu` and is not
it."""

import ast

import pytest

from benchmark import harness, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "mpas_tpu"}


def modules(path) -> set:
    """Full names of every module a file imports (relative imports stay
    inside the benchmark)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value))
    return names


def imported(path) -> set:
    """Top-level names of every module a file imports."""
    return {m.split(".")[0] for m in modules(path)}


def sources(folder):
    return sorted(p for p in folder.rglob("*.py") if "tests" not in p.parts)


def test_nothing_imports_jax():
    files = sources(spec.ROOT)
    assert len(files) > 30
    for path in files:
        assert not imported(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    """The frozen reference, and every configuration's own reference
    module under `references/`, which may build on the frozen one (a
    module loaded from its file imports it by its absolute name)."""
    allowed = {"__future__", "dataclasses", "typing", "math", "time",
               "warnings", "json", "numpy", "torch", "scipy"}
    files = sources(spec.ROOT / "reference") + sources(
        spec.ROOT / "references")
    assert files
    for path in files:
        outside = {m for m in modules(path) if m.split(".")[0] not in allowed
                   and m.split(".")[:2] not in (["benchmark", "reference"],
                                                ["benchmark", "references"])}
        assert not outside, (path, outside)


@pytest.mark.parametrize("name,hit", [
    ("mpas_tpu_torch", False), ("mpas_tpu_torch.ops", False),
    ("mpas_tpu", True), ("mpas_tpu.ops.stencils", True), ("jax", True),
    ("jax.numpy", True), ("jaxlib", True), ("flax.linen", True),
    ("jaxtyping", False), ("benchmark", False)])
def test_whole_names_are_compared(name, hit, monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, name, object())
    assert bool(harness.forbidden_modules()) == (
        hit or bool({m.split(".")[0] for m in sys.modules if m != name}
                    & FORBIDDEN))


def test_the_harness_finds_what_is_loaded():
    """The CPU tests load no JAX here, so what the harness reports is what
    this process holds."""
    import sys
    held = {m.split(".")[0] for m in sys.modules} & FORBIDDEN
    assert harness.forbidden_modules() == sorted(held)
