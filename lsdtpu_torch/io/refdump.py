"""Reference-format artifact dumps, for interop with the C++ engine (the
port's own copy of lsdtpu/io/refdump.py; numpy only).

The reference author saved intermediate artifacts as whitespace text:
`data/MaplinesInfo.txt` / `ScanlinesInfo.txt` (10-column structLinesInfo
rows, LSD/baseFunc.h:33-44), `data/MaplineIm.txt` / `ScanlineIm.txt`
(row-major integer line images, written 1-based so shifted (+1, +1) vs
the in-memory lineIm), and `data/mapCache.txt` (row-major doubles; the
file LSD/test.cpp:8-30 micro-benchmarks loading).  This module writes
the same formats, so a reference deployment can consume map artifacts
the port prepared, and the port can read artifacts the C++ build dumped
(io/loaders.load_lines_info, and load_map_cache here).  The writers take
numpy arrays: pass tensors as ``t.cpu().numpy()``.

Values are written with %.15g (the dumps' 15 significant digits) and tab
separators.
"""

from __future__ import annotations

import os

import numpy as np


def save_lines_info(path: str, lines: np.ndarray,
                    mask: np.ndarray | None = None) -> int:
    """Write linesInfo rows [k b dx dy x1 y1 x2 y2 len orient]
    (reference dump format, readable by io.loaders.load_lines_info).
    Returns the number of rows written."""
    lines = np.asarray(lines, np.float64)
    if mask is not None:
        lines = lines[np.asarray(mask, bool)]
    with open(path, "w") as f:
        for row in lines:
            f.write("\t".join("%.15g" % v for v in row) + "\n")
    return len(lines)


def save_grid(path: str, grid: np.ndarray, fmt: str = "%d") -> None:
    """Row-major whitespace grid (lineIm / mapValue / mapCache style)."""
    np.savetxt(path, np.asarray(grid), fmt=fmt, delimiter="\t")


def save_line_im(path: str, line_im: np.ndarray,
                 one_based_shift: bool = True) -> None:
    """Write a lineIm dump (0/1 values).  The reference's saved images are
    offset by (+1, +1) relative to the in-memory array (its 1-based
    display path); ``one_based_shift`` applies the same convention, so the
    output compares byte for byte with the C++ build's dumps."""
    img = (np.asarray(line_im) > 0).astype(np.int64)
    if one_based_shift:
        shifted = np.zeros_like(img)
        shifted[:-1, :-1] = img[1:, 1:]
        img = shifted
    save_grid(path, img, "%d")


def save_map_cache(path: str, cache: np.ndarray) -> None:
    """Write the distance field in the mapCache.txt format the
    reference's test.cpp loads (row-major %.15g doubles)."""
    save_grid(path, np.asarray(cache, np.float64), "%.15g")


def load_map_cache(path: str) -> np.ndarray:
    """Read a mapCache.txt dump (the port's or the C++ build's)."""
    return np.loadtxt(path, dtype=np.float64)


def dump_map_artifacts(out_dir: str, lines: np.ndarray, cache: np.ndarray,
                       line_im: np.ndarray | None = None,
                       prefix: str = "Map") -> dict:
    """Write the reference artifact set of one prepared map:
    {prefix}linesInfo.txt, mapCache.txt and (optionally)
    {prefix}lineIm.txt.  Returns the written paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    p = os.path.join(out_dir, f"{prefix}linesInfo.txt")
    save_lines_info(p, lines)
    paths["lines_info"] = p
    p = os.path.join(out_dir, "mapCache.txt")
    save_map_cache(p, cache)
    paths["map_cache"] = p
    if line_im is not None:
        p = os.path.join(out_dir, f"{prefix}lineIm.txt")
        save_line_im(p, line_im)
        paths["line_im"] = p
    return paths
