"""Nothing under portbench/ imports jax or the JAX package v2e_tpu, and
nothing under portbench/reference/ imports the port: module names compared
by their top-level name, whole (v2e_tpu_torch is not v2e_tpu)."""
import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "v2e_tpu"}


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
            elif isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                names.add(arg.values[0].value.split(".")[0])
    return names


def sources(sub=""):
    root = os.path.join(HERE, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")), ids=lambda p: os.path.relpath(p, HERE))
def test_reference_takes_nothing_from_the_port(path):
    assert "v2e_tpu_torch" not in top_level_imports(path)


def test_top_level_names_are_compared_whole():
    from portbench.bench import forbidden_modules

    import v2e_tpu_torch  # noqa: F401  (begins with v2e_tpu, is not it)

    assert "v2e_tpu_torch" not in forbidden_modules()
