"""The port does all that the JAX package does, by name: every public
function, class and method of every lsdtpu/**/*.py has a counterpart of
the same name in the module of the same path under lsdtpu_torch/, but
for the renames stated in RENAMED and MODULES, which are the only
differences between the two packages' public names.  Both trees are
parsed with ast; neither package is imported.

A second check holds the repo's Pallas kernels: its pl.pallas_call sites
are exactly the two in MODULES, each with its Hopper kernel."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "lsdtpu", ROOT / "lsdtpu_torch"

# (module, name in lsdtpu) -> name in lsdtpu_torch's module of that path
RENAMED = {
    ("runtime/loop.py", "vmapped_cfg"): "batched_cfg",
    ("runtime/checkpoint.py", "save_state_orbax"): "save_state_dcp",
    ("runtime/checkpoint.py", "load_state_orbax"): "load_state_dcp",
}
# Pallas modules of lsdtpu -> (the port's wrapper module, its CUDA
# kernel), and the pl.pallas_call each module holds: (line, function)
MODULES = {
    "ops/score_pallas.py": ("ops/score.py", "csrc/score.cu"),
    "ops/nfa_pallas.py": ("ops/nfa.py", "csrc/nfa.cu"),
}
PALLAS_CALLS = {
    "ops/score_pallas.py": [(162, "score_candidates_pallas")],
    "ops/nfa_pallas.py": [(104, "rect_counts_pallas")],
}
SKIP_DIRS = {"build", "chiprun_out", "__pycache__"}

REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def public_names(path):
    """Top-level public functions and classes, and "Class.method" for
    each public method."""
    out = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) or node.name.startswith("_"):
            continue
        out.add(node.name)
        if isinstance(node, ast.ClassDef):
            out.update(f"{node.name}.{m.name}" for m in node.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                       and not m.name.startswith("_"))
    return out


def pallas_calls(path):
    """(line, enclosing top-level function) of each pl.pallas_call."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for top in tree.body:
        for node in ast.walk(top):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and \
                    node.func.attr == "pallas_call":
                out.append((node.lineno, getattr(top, "name", None)))
    return out


def test_reference_modules_found():
    assert len(REF_MODULES) > 40
    assert set(MODULES) <= set(REF_MODULES)


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    if rel in MODULES:
        for target in MODULES[rel]:
            assert (PORT / target).is_file(), target
        return
    port = PORT / rel
    assert port.is_file(), f"lsdtpu_torch/{rel} missing"
    have = public_names(port)
    missing = sorted(RENAMED.get((rel, n), n) for n in public_names(REF / rel)
                     if RENAMED.get((rel, n), n) not in have)
    assert not missing, f"lsdtpu_torch/{rel} lacks {missing}"


@pytest.mark.parametrize("rel, name", sorted(RENAMED))
def test_renames_are_real(rel, name):
    """Each rename names a reference function that exists and a port
    function that exists, and the port does not keep the old name."""
    assert name in public_names(REF / rel)
    port = public_names(PORT / rel)
    assert RENAMED[(rel, name)] in port and name not in port


def test_pallas_call_sites_are_the_ported_kernels():
    found = {}
    for path in sorted(ROOT.rglob("*.py")):
        rel = path.relative_to(ROOT)
        if SKIP_DIRS & set(rel.parts) or any(
                part.startswith(".") for part in rel.parts):
            continue
        calls = pallas_calls(path)
        if calls:
            found[str(rel)] = calls
    assert found == {f"lsdtpu/{k}": v for k, v in PALLAS_CALLS.items()}
    assert set(PALLAS_CALLS) == set(MODULES)


def test_checker_sees_a_missing_name(tmp_path):
    a, b = tmp_path / "a.py", tmp_path / "b.py"
    a.write_text("def f(): pass\nclass C:\n    def m(self): pass\n"
                 "    def _p(self): pass\ndef _g(): pass\n")
    b.write_text("def f(): pass\nclass C:\n    pass\n")
    assert public_names(a) - public_names(b) == {"C.m"}
    assert pallas_calls(tmp_path / "a.py") == []
