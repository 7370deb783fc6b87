"""Native (C++) dataset text parser, built with the host C++ compiler at
first use (the port's own copy of the reference package's parser).

``_parser.cpp`` is a CPython extension with no numpy or PyTorch
dependency.  It is compiled once per Python version and source into the
port's build directory (``ops/build.BUILD_DIR``: ``build/lsdtpu_torch/``
in a checkout) and loaded from there.  Where it cannot be built (no
compiler) the loaders parse with numpy instead (io/loaders.py);
``available()`` says which route they take, ``build_error()`` why the
native one is missing, and ``load_grid_native.calls`` /
``load_doubles_native.calls`` count the files parsed natively.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sys
import sysconfig
from pathlib import Path
from typing import Optional

import numpy as np

from lsdtpu_torch.ops.build import BUILD_DIR

_SRC = Path(__file__).resolve().with_name("_parser.cpp")
_NAME = "_lsdtpu_torch_parser"

_state = {"mod": None, "tried": False, "error": None}


def _build_and_load():
    if _state["tried"]:
        return _state["mod"]
    _state["tried"] = True
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    so = BUILD_DIR / (f"{_NAME}.{sys.version_info[0]}{sys.version_info[1]}"
                      f".{tag}.so")
    try:
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [os.environ.get("CXX", "g++"), "-O3", "-shared", "-fPIC",
                   f"-I{sysconfig.get_paths()['include']}", str(_SRC), "-o",
                   str(tmp)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise OSError(f"{' '.join(cmd)} failed:\n{res.stderr}")
            os.replace(tmp, so)      # atomic: concurrent builds agree
        loader = importlib.machinery.ExtensionFileLoader(_NAME, str(so))
        spec = importlib.util.spec_from_loader(_NAME, loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        _state["mod"] = mod
    except (OSError, ImportError) as e:
        _state["error"] = f"{type(e).__name__}: {e}"
    return _state["mod"]


def available() -> bool:
    """True when the native parser is built and loaded (the loaders'
    route); False when they parse with numpy."""
    return _build_and_load() is not None


def build_error() -> Optional[str]:
    """Why the native parser could not be built or loaded, or None."""
    _build_and_load()
    return _state["error"]


def load_grid_native(path: str, rows: int, cols: int
                     ) -> Optional[np.ndarray]:
    """(rows, cols) uint8 grid of the first rows * cols integer tokens,
    or None without the native parser."""
    m = _build_and_load()
    if m is None:
        return None
    raw = m.parse_grid(path, rows * cols)
    load_grid_native.calls += 1
    return np.frombuffer(raw, dtype=np.uint8).reshape(rows, cols).copy()


load_grid_native.calls = 0


def load_doubles_native(path: str) -> Optional[np.ndarray]:
    """Every float64 token of a text file (inf included), flat, or None
    without the native parser."""
    m = _build_and_load()
    if m is None:
        return None
    raw = m.parse_doubles(path)
    load_doubles_native.calls += 1
    return np.frombuffer(raw, dtype=np.float64).copy()


load_doubles_native.calls = 0
