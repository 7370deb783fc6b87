"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program: every import of every module,
by ``ast``, its top-level name compared whole (``lsdtpu_torch`` begins
with ``lsdtpu``)."""

import ast

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "lsdtpu"}


def top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def modules(sub=""):
    return sorted((BENCH / sub).rglob("*.py"))


def test_every_module_parses_and_is_seen():
    found = modules()
    assert any(p.name == "run.py" for p in found)
    assert len(list(modules("reference"))) >= 5
    for p in found:
        top_level_imports(p)


def test_no_module_imports_jax_or_the_jax_package():
    bad = {str(p.relative_to(BENCH)): sorted(top_level_imports(p) & FORBIDDEN)
           for p in modules()}
    assert {k: v for k, v in bad.items() if v} == {}


def test_reference_imports_nothing_of_the_program():
    for p in modules("reference"):
        names = top_level_imports(p)
        assert "lsdtpu_torch" not in names, p
        assert names <= {"__future__", "dataclasses", "math", "collections",
                         "multiprocessing", "os", "typing", "numpy",
                         "reference"}, (p, names)


def test_whole_names_are_compared():
    # the program's name begins with the JAX package's: a prefix test
    # would flag it, a whole-name test must not
    assert "lsdtpu_torch" not in FORBIDDEN
    assert not ({"lsdtpu_torch"} & FORBIDDEN)
