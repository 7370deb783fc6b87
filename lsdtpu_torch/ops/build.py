"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file has a plain ``extern "C"`` interface (no
PyTorch headers), so ``nvcc`` builds it in seconds into
``build/lsdtpu_torch/`` under the repository root in a checkout, or into
``_build/`` inside the package where it is installed, named by a hash
of the source and the flags; a changed source builds anew.  The library
is loaded with ctypes.  Only the sources in the repository are built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = (_PKG.parent / "build" / "lsdtpu_torch"
             if (_PKG.parent / "pyproject.toml").exists() else _PKG / "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas", "-v"]

_LIBS: dict = {}
# ptxas resource report and build seconds of each library built by this
# process: {name: {"seconds": float, "ptxas": str}}
BUILD_LOG: dict = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built from source at first use")


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (cached per process)."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    flags = ARCH_FLAGS + NVCC_FLAGS
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()
                            ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run([nvcc_path(), *flags, "-o", str(tmp), str(src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
        os.replace(tmp, out)       # atomic: concurrent builds agree
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": res.stderr.strip()}
    _LIBS[name] = ctypes.CDLL(str(out))
    return _LIBS[name]


def load_libraries(names) -> None:
    """Build and load ``csrc/<name>.cu`` for every name: one nvcc per
    source, all started together."""
    with ThreadPoolExecutor(max(1, len(names))) as ex:
        for fut in [ex.submit(load_library, n) for n in names]:
            fut.result()
