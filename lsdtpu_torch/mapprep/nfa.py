"""NFA validation: rectangle rasterize + count on the device, binomial
tail on the host (counterpart of lsdtpu/mapprep/nfa.py).

Reference: RectangleNFACalculator / LogGammaCalculator /
RectangleImprover, LSD/myLSD.cpp:882-1158.  The counts go through
``ops.nfa.rect_counts`` (the CUDA kernel on the card, its plain version
on the CPU).  Each call brings its (R, 2) counts to the host once; the
binomial tail and the improver's bookkeeping then run on numpy scalars
of the working dtype, op for op as the reference package writes them
(every constant is cast to the working dtype, as its weakly typed
Python constants are), so no loop iteration waits on the device.

A rectangle is a dict of numpy scalars of the working dtype: x1, y1,
x2, y2, wid, c_x, c_y, deg, dx, dy, p, prec (mapprep/rect.py builds
it).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lsdtpu_torch.mapprep.stats import MapPrepStats
from lsdtpu_torch.ops import nfa as onfa
from lsdtpu_torch.runtime.collectives import Axis

PI = math.pi
EPS = 2.2204e-16
TOLE = 0.1

_LANCZOS_Q = (75122.6331530, 80916.6278952, 36308.2951477, 8687.24529705,
              1168.92649479, 83.8676043424, 2.50662827511)


def log_gamma(x: np.ndarray) -> np.ndarray:
    """Windschitl above 15, Lanczos below (myLSD.cpp:882-924); x > 0,
    an array of the working dtype."""
    t = x.dtype.type
    xs = np.maximum(x, t(1e-12))
    x2 = xs * xs
    x6 = x2 * (x2 * x2)        # the reference package's integer power
    win = (t(0.918938533204673) + (xs - t(0.5)) * np.log(xs) - xs +
           t(0.5) * xs * np.log(xs * np.sinh(t(1.0) / xs) +
                                t(1.0) / (t(810.0) * x6)))
    q = np.asarray(_LANCZOS_Q, x.dtype)
    a = (xs + t(0.5)) * np.log(xs + t(5.5)) - (xs + t(5.5))
    i = np.arange(7, dtype=x.dtype)
    a = a - np.sum(np.log(xs[..., None] + i), axis=-1)
    b = np.sum(q * xs[..., None] ** i, axis=-1)
    lan = a + np.log(b)
    return np.where(x > t(15.0), win, lan)


def pack_rect_scalars(rec) -> np.ndarray:
    """Rectangle -> the (N_SCALARS,) packed vector rect_counts consumes:
    vertex sort (myLSD.cpp:946-970), column range, the four edge
    slopes."""
    t = type(rec["x1"])
    half_w = rec["wid"] / t(2.0)
    x1, x2, y1, y2 = rec["x1"], rec["x2"], rec["y1"], rec["y2"]
    dx, dy = rec["dx"], rec["dy"]
    ver_x = [x1 - dy * half_w, x2 - dy * half_w, x2 + dy * half_w,
             x1 + dy * half_w]
    ver_y = [y1 + dx * half_w, y2 + dx * half_w, y2 - dx * half_w,
             y1 - dx * half_w]
    off = (0 if (x1 < x2) and (y1 <= y2) else
           1 if (x1 >= x2) and (y1 < y2) else
           2 if (x1 > x2) and (y1 >= y2) else 3)
    vx = [ver_x[(off + i) % 4] for i in range(4)]
    vy = [ver_y[(off + i) % 4] for i in range(4)]
    x_start = np.ceil(vx[0])
    x_len = np.abs(np.ceil(vx[0]) - np.floor(vx[2])) + t(1.0)
    ks = [(vy[1] - vy[0]) / (vx[1] - vx[0]), (vy[2] - vy[1]) / (vx[2] - vx[1]),
          (vy[2] - vy[3]) / (vx[2] - vx[3]), (vy[3] - vy[0]) / (vx[3] - vx[0])]
    return np.array([x_start, x_len, *vx, *vy, *ks, rec["deg"], rec["prec"]],
                    dtype=t)


def rectangles_nfa(recs, deg_map: torch.Tensor, log_nt: float,
                   stats: MapPrepStats, row0: int = 0,
                   axis: Axis = Axis.none(), n_rows=None) -> list:
    """-log10 NFA of each rectangle of ``recs`` (reference:
    RectangleNFACalculator, myLSD.cpp:926-1059): one rect_counts call
    over the batch, one transfer of its counts to the host.  Row-block
    sharding (mapprep/lsd_sharded.py): deg_map is this rank's rows
    [row0, row0 + H) of a field of true height n_rows, and the block
    counts are psummed over ``axis`` (a runtime/collectives.Axis); the
    binomial tail then runs on every rank alike."""
    with np.errstate(all="ignore"):
        sc = np.stack([pack_rect_scalars(r) for r in recs])
    all_pix, ali_pix = onfa.rect_counts(deg_map, torch.from_numpy(sc).to(
        deg_map.device), row0, n_rows)
    stats.nfa_calls += 1
    stats.nfa_rects += len(recs)
    counts = stats.to_host("nfa",
                           axis.psum(torch.stack([all_pix, ali_pix])))
    t = sc.dtype.type
    return [_binom_tail_nfa(t(a), t(b), r["p"], log_nt)
            for a, b, r in zip(counts[0], counts[1], recs)]


def rectangle_nfa(rec, deg_map: torch.Tensor, log_nt: float,
                  stats: MapPrepStats, **block):
    """-log10 NFA of one rectangle (``block``: rectangles_nfa's row0,
    axis and n_rows)."""
    return rectangles_nfa([rec], deg_map, log_nt, stats, **block)[0]


def _binom_tail_nfa(all_pix, ali_pix, p, log_nt: float):
    """-log10 of the binomial tail NFA (myLSD.cpp:1017-1058); all_pix,
    ali_pix and p are scalars of the working dtype."""
    t = type(p)
    one = t(1.0)
    with np.errstate(all="ignore"):
        if all_pix == 0 or ali_pix == 0 or all_pix == ali_pix:
            if all_pix == 0 or ali_pix == 0:
                return t(-log_nt)
            return t(-log_nt) - all_pix * np.log10(p)
        pro_term = p / (one - p)
        lg = log_gamma(np.array([all_pix + one, ali_pix + one,
                                 all_pix - ali_pix + one], dtype=t))
        log1 = (lg[0] - lg[1] - lg[2] + ali_pix * np.log(p) +
                (all_pix - ali_pix) * np.log(one - p))
        term0 = np.exp(log1)
        if np.abs(term0) < t(100.0 * EPS):
            if ali_pix > all_pix * p:
                return -np.log10(term0) - t(log_nt)
            return t(-log_nt)
        i = ali_pix + one
        term = tail = term0
        while i <= all_pix:
            bin_term = (all_pix - i + one) / i
            mult = bin_term * pro_term
            term = term * mult
            tail = tail + term
            err = term * ((one - mult ** (all_pix - i + one)) /
                          (one - mult) - one)
            i = i + one
            if bin_term < one and err < (t(TOLE) * np.abs(
                    -np.log10(tail) - t(log_nt)) * tail):
                break
        return -np.log10(tail) - t(log_nt)


def _half_p(r):
    t = type(r["p"])
    r["p"] = r["p"] / t(2.0)
    r["prec"] = r["p"] * t(PI)
    return r


def _shrink_wid(r):
    r["wid"] = r["wid"] - type(r["wid"])(0.5)
    return r


def _shift_side(sign):
    def shift(r):
        t = type(r["x1"])
        dx2 = r["dx"] * t(0.25)
        dy2 = r["dy"] * t(0.25)
        if sign > 0:
            r["x1"], r["y1"] = r["x1"] - dy2, r["y1"] + dx2
            r["x2"], r["y2"] = r["x2"] - dy2, r["y2"] + dx2
        else:
            r["x1"], r["y1"] = r["x1"] + dy2, r["y1"] - dx2
            r["x2"], r["y2"] = r["x2"] + dy2, r["y2"] - dx2
        r["wid"] = r["wid"] - t(0.5)
        return r
    return shift


# (update, gated): 5x p/2, 5x wid-0.5, 5x each lateral shift, 5x p/2
_PHASES = ((_half_p, False), (_shrink_wid, True), (_shift_side(1), True),
           (_shift_side(-1), True), (_half_p, False))


def rectangle_improver(rec, deg_map: torch.Tensor, log_nt: float,
                       stats: MapPrepStats, **block):
    """Greedy NFA improvement (reference: RectangleImprover,
    myLSD.cpp:1061-1158), stopping at the first phase that reaches
    NFA > 0.  Returns (log_nfa, rec).

    A phase's up to 5 trial rectangles depend only on the previous
    trial, never on an NFA value (the width gate reads only ``wid``), so
    a phase is one rect_counts call over its trials, and the ``better``
    chain then runs over their values in order.  A gated trial that
    would cross the width floor is skipped, and so are the ones after
    it (the width no longer changes): the reference package evaluates
    them and discards their values.  ``block``: rectangles_nfa's row0,
    axis and n_rows."""
    log_nfa = rectangle_nfa(rec, deg_map, log_nt, stats, **block)
    best = dict(rec)
    half = type(rec["wid"])(0.5)
    for update, gated in _PHASES:
        if log_nfa > 0.0:
            break
        trials, new = [], dict(best)
        for _ in range(5):
            if gated and not (new["wid"] - half >= half):
                break
            new = update(dict(new))
            trials.append(new)
        if not trials:
            continue
        for new, cand in zip(trials, rectangles_nfa(trials, deg_map, log_nt,
                                                    stats, **block)):
            if cand > log_nfa:
                log_nfa, best = cand, new
    return log_nfa, best
