"""Import hygiene of the port: no module of lsdtpu_torch, and not
chip_smoke.py, imports jax or the reference package lsdtpu (the port
keeps its own copies of what it needs)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "lsdtpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "lsdtpu")


def test_files_found():
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [n for n in _imported(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_catches_forbidden_imports():
    assert _forbidden("jax.numpy") and _forbidden("lsdtpu.geometry")
    assert _forbidden("lsdtpu") and not _forbidden("lsdtpu_torch.geometry")
