#!/usr/bin/env python3
"""Speed-of-light bound of the port's rollout on one NVIDIA card
(counterpart of scripts/sol_bound.py).

    python3 scripts/torch_sol_bound.py [--data DIR] [--device cuda|cpu]

Counts the distance-field cells the rollout gathers over a sequence (the
dominant bound term) and prints the achievable-floor arithmetic with
constants measured on this card, in this process.  The map is the
numpy oracle's (oracle/driver.prepare_map), the shapes the bench's
(bench.bench_cfg: K = 4096 candidates, P = 2048 scan pixels), the
working type f32.

Counting (``rollout_counts``: runtime/loop.py's stages frame by frame,
the candidate set passed back into match_stage so that the counted set
is the scored set): each frame's live candidates, live scan pixels,
survivors of the pruning bound (match/associate._group_stats and
_chunk_bound over the full candidate set, tested against
match.score_accept) and whether it tracks.  Three gather counts
(``gather_counts``):

  * useful: the reference script's count, which no implementation
    changes: live_cand x G + n_surv x live_pix on a pruned frame (G =
    max_scan_pixels / prune_group bound groups), live_cand x live_pix on
    a plain one;
  * as chunked: the reference scorer's chunk grids (match.score_chunk x
    match.score_pixel_chunk, both padded up), printed so that the two
    scripts compare line for line; the port reads neither field;
  * as the port gathers, read from its code: on a pruned frame
    (match.prune, and the live count at least match.prune_min_live:
    match/associate.py:315) prune_survivors (associate.py:466) runs
    _chunk_bound over all K = shapes.max_candidates slots x G groups,
    one coarse-field cell each (associate.py:452-456), and the CalcScore
    kernel then sweeps n_surv x live_pix (associate.py:537,
    ops/score.py:split); on a plain frame the kernel sweeps live_cand x
    live_pix (associate.py:338, 257).

The card's constants (``measure_constants``), each printed with its
method; none is taken from the reference script:

  * the gather rate: torch.index_select of the field at GATHERS int32
    indices, once with the relock frame's own cell pattern (its scored
    (candidate, pixel) pairs in the kernel's order, tiled) and once
    uniform random; and the CalcScore kernel's own rate on that frame
    (the in-map cells of its launch over its profiled device time, each
    repeat bitwise the first).  The bound takes the highest of the three
    and names it;
  * H2D: the stacked frames (stack_frames) copied to the card
    (loop.to_device), median time to completion;
  * the loop floor: frames x the launch floor (chip_smoke.py's
    launch_floor_ms: the profiler's device time of a one-element add_;
    the timing helpers are chip_smoke.py's);
  * featurize and UKF as built (not bounds): the device-busy ms of each
    stage over the rollout, from torch.profiler, the stages run apart as
    runtime/trace.stage_timings runs them (featurize_stage on every
    frame's inputs, ukf_step on every frame's filter inputs as the
    counting rollout recorded them).

With ``--device cpu`` the counts are printed and the constants are not:
they need a card.  ``--device cuda`` (the default) without a card
exits 2.  The last line of the output is one JSON object (counts,
constants, floors).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

GATHERS = 10 ** 8     # indices a rate measurement gathers at least
H2D_REPEATS = 10      # timed frame-stack copies (median reported)
RATE_REPEATS = 10     # timed gathers of each pattern (mean reported)


def scene_context(ds, dtype, device, art=None):
    """(MapContext on ``device``, stacked frames as numpy arrays) of a
    Dataset, on the oracle's map artifacts (``art``: made here when
    None)."""
    from lsdtpu_torch.oracle import driver as odrv
    from lsdtpu_torch.runtime import loop
    if art is None:
        art = odrv.prepare_map(ds.map_value, ds.param.resol)
    ctx = loop.make_map_context(art.lines_info, art.map_cache,
                                ds.param.resol, ds.param.ori_x,
                                ds.param.ori_y, dtype=dtype, device=device)
    return ctx, loop.stack_frames(ds, dtype=dtype)


def rollout_counts(frames, ctx, cfg, device, steps=None):
    """The counting rollout over ``frames`` (stack_frames' dict, numpy
    or tensors) with ``ctx`` on ``device``: numpy arrays live_cand,
    live_pix, n_surv (int64) and tracking (bool), one entry a frame.
    ``steps``: a list that receives each frame's (featurize output,
    state before the frame, match outputs) on the device."""
    import torch
    from lsdtpu_torch import geometry as geo
    from lsdtpu_torch import resolve_device
    from lsdtpu_torch.match import associate as assoc
    from lsdtpu_torch.runtime import loop
    dev = resolve_device(device)
    fr = loop.to_device(frames, dev)
    m = cfg.match
    state = loop.init_state(fr["ranges"].dtype, dev)
    coarse = loop.prepare_coarse(ctx, cfg)
    ch, cw = coarse.shape
    recs = []
    for f in range(fr["ranges"].shape[0]):
        inputs = tuple(fr[k][f] for k in loop._FRAME_KEYS)
        fs = loop.featurize_stage(inputs, ctx, cfg)
        cand = assoc.generate_candidates(
            fs.lines, fs.lines_mask, ctx.lines, ctx.lines_mask,
            geo.c_round(fs.lidar_pos), state.last_pose,
            max_candidates=cfg.shapes.max_candidates,
            ignore_scan_length=m.ignore_scan_length,
            scan_to_map_diff=m.scan_to_map_diff,
            max_esti_dist=m.max_esti_dist)
        # survivors of the pruning bound, with the real bound helpers on
        # the full candidate set (the pruned scorer's bound, unchunked)
        dt = cand.ca.dtype
        gs = assoc._group_stats(fs.pixels, fs.pixels_mask, m.prune_group, dt)
        bounds = assoc._chunk_bound(
            (cand.ca, cand.sa, cand.sx, cand.sy, cand.mx, cand.my), gs,
            coarse.reshape(-1), cw, ch, m.prune_block, ctx.rows, ctx.cols,
            cfg.map.z_occ_max_dis, m.max_dist_penalty, m.obstacle_tolerance,
            m.valid_ratio, fs.pixels_mask.sum().to(dt), dt)
        n_surv = ((bounds < m.score_accept) & cand.mask).sum()
        new_state, out = loop.match_stage(state, fs, inputs, ctx, cfg,
                                          coarse=coarse, cand=cand)
        if steps is not None:
            steps.append((fs, state, out))
        recs.append(torch.stack([
            cand.mask.sum(), fs.pixels_mask.sum(), n_surv,
            (torch.abs(state.last_pose[0] + 1) >= 1e-4).to(torch.int64)]))
        state = new_state
    r = torch.stack(recs).cpu().numpy().astype(np.int64)
    return {"live_cand": r[:, 0], "live_pix": r[:, 1], "n_surv": r[:, 2],
            "tracking": r[:, 3].astype(bool)}


def gather_counts(recs, cfg):
    """Per-frame gathered cells of the three counts (module docstring):
    {"pruned", "useful", "as_chunked", "as_built"} numpy arrays, with
    the grids ``kc``, ``kp``, ``G`` and ``K``."""
    m = cfg.match
    kc, kp = m.score_chunk, m.score_pixel_chunk
    K = cfg.shapes.max_candidates
    G = -(-cfg.shapes.max_scan_pixels // m.prune_group)
    lc, lp, ns = recs["live_cand"], recs["live_pix"], recs["n_surv"]
    # the port gates on the pre-truncation count (associate.py:315); it
    # reaches prune_min_live exactly when the live count does (K >= it)
    pruned = np.full(lc.shape, m.prune and m.score_dynamic_chunks) & (
        lc >= m.prune_min_live)

    def pad(x, c):
        return -(-x // c) * c

    return dict(
        pruned=pruned, kc=kc, kp=kp, G=G, K=K,
        useful=np.where(pruned, lc * G + ns * lp, lc * lp),
        as_chunked=np.where(pruned,
                            pad(lc, kc) * G + pad(ns, kc) * pad(lp, kp),
                            pad(lc, kc) * pad(lp, kp)),
        as_built=np.where(pruned, K * G + ns * lp, lc * lp))


def print_counts(recs, counts):
    """The reference script's count lines, in its exact form, and the
    port's as-built count."""
    lc, lp, ns, tr = (recs[k] for k in ("live_cand", "live_pix", "n_surv",
                                        "tracking"))
    F = lc.shape[0]
    swept, live = counts["as_chunked"], counts["useful"]
    print(f"frames={F} (tracking {tr.sum()}, relock {F - tr.sum()}; "
          f"pruned-path frames {counts['pruned'].sum()})")
    print(f"live candidates: tracking mean {lc[tr].mean():.1f} "
          f"(max {lc[tr].max()}), relock {lc[~tr].tolist()} "
          f"-> survivors {ns[~tr].tolist()}")
    print(f"live pixels: mean {lp.mean():.1f}  max {lp.max()}")
    print(f"gathered cells, chunk grids {counts['kc']}x{counts['kp']} "
          f"(G={counts['G']}): total {swept.sum():,} "
          f"(useful {live.sum():,}, padding {1 - live.sum()/swept.sum():.1%})")
    built = counts["as_built"]
    print(f"gathered cells, as the port gathers (K={counts['K']} bound "
          f"slots x G={counts['G']} on pruned frames, live pairs else): "
          f"total {built.sum():,} (useful {live.sum():,}, "
          f"overhead {1 - live.sum()/built.sum():.1%})", flush=True)


def relock_launch(frames, ctx, cfg, f):
    """The CalcScore launch arguments of relock frame ``f`` (no prior
    pose) as the scorer makes them (the survivor list on a pruned
    frame), and the flat field index of every cell it gathers: its
    in-map (slot, pixel) pairs in the kernel's order."""
    import torch
    from lsdtpu_torch import geometry as geo
    from lsdtpu_torch.match import associate as assoc
    from lsdtpu_torch.runtime import loop
    m = cfg.match
    dev = ctx.cache.device
    inputs = tuple(torch.as_tensor(np.asarray(frames[k][f]), device=dev)
                   for k in loop._FRAME_KEYS)
    fs = loop.featurize_stage(inputs, ctx, cfg)
    cand = assoc.generate_candidates(
        fs.lines, fs.lines_mask, ctx.lines, ctx.lines_mask,
        geo.c_round(fs.lidar_pos),
        loop.init_state(ctx.lines.dtype, dev).last_pose,
        cfg.shapes.max_candidates, m.ignore_scan_length,
        m.scan_to_map_diff, m.max_esti_dist)
    K = cand.ca.shape[0]
    z = cfg.map.z_occ_max_dis
    if m.prune and int(cand.count) >= m.prune_min_live:
        idx, n = assoc.prune_survivors(
            cand, fs.pixels, fs.pixels_mask, loop.prepare_coarse(ctx, cfg),
            ctx.rows, ctx.cols, z, m.max_dist_penalty, m.valid_ratio,
            m.obstacle_tolerance, m.score_accept, m.prune_block,
            m.prune_group)
    else:
        idx, n = None, cand.count.clamp(0, K).to(torch.int32)
    feats = cand.feats()
    px, py, n_pix = assoc.pixel_args(fs.pixels, fs.pixels_mask,
                                     cand.ca.dtype)
    args = (feats, idx, n, px, py, n_pix, ctx.cache, 0, ctx.rows, ctx.cols,
            z, m.max_dist_penalty, z)
    nl, P = int(n), int(n_pix)
    sel = torch.arange(nl, device=dev) if idx is None else idx[:nl].long()
    ca, sa, sx, sy, mx, my = feats[:, sel][:, :, None]
    tx = (px[None, :P] - sx) * ca - (py[None, :P] - sy) * sa + mx
    ty = (px[None, :P] - sx) * sa + (py[None, :P] - sy) * ca + my
    fx, fy = geo.c_round(tx), geo.c_round(ty)
    inside = (fx >= 0) & (fx < ctx.cols) & (fy >= 0) & (fy < ctx.rows)
    cells = (fy * ctx.cache.shape[1] + fx)[inside].to(torch.int32)
    return args, cells, nl, P


def measure_constants(frames, ctx, cfg, recs, smoke, steps,
                      profile_frames=None):
    """The card's constants (module docstring), each a dict with its
    value and method: gather_rate (with the three rates), h2d_ms,
    loop_floor_ms, featurize_ms and ukf_ms.  ``smoke``: chip_smoke.py as
    a module (its launch floor, timing and profiler helpers); ``steps``:
    the counting rollout's per-frame record.  Returns (constants, the
    relock frame's CalcScore launch as dict(args, out, launches): its
    arguments, its output and how many times it was launched, each
    launch bitwise that output)."""
    import torch
    from lsdtpu_torch.filter import ukf as fukf
    from lsdtpu_torch.ops import score as sc
    from lsdtpu_torch.runtime import loop
    dev = ctx.cache.device
    F = len(recs["live_cand"])
    out = {}

    # --- gather rates --------------------------------------------------
    relock = np.flatnonzero(~recs["tracking"])
    if relock.size == 0:
        raise ValueError("no relock frame: the gather pattern needs one")
    f_relock = int(relock[np.argmax(recs["live_cand"][relock])])
    args, cells, nl, P = relock_launch(frames, ctx, cfg, f_relock)
    flat = ctx.cache.reshape(-1)
    rates = {}
    coherent = cells.repeat(-(-GATHERS // cells.numel()))
    rnd = torch.randint(0, flat.numel(), (GATHERS,), dtype=torch.int32,
                        device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    for name, idx in (("coherent", coherent), ("random", rnd)):
        buf = torch.empty(idx.numel(), dtype=flat.dtype, device=dev)
        ms = smoke.time_cuda(
            lambda: torch.index_select(flat, 0, idx, out=buf), RATE_REPEATS)
        rates[name] = dict(
            rate=idx.numel() / ms * 1e3, ms=ms, gathers=idx.numel(),
            method=(f"torch.index_select of the {flat.dtype} field at "
                    f"{idx.numel()} int32 indices "
                    + ("(the relock frame's in-map cells in the kernel's "
                       f"order, {cells.numel()} tiled)" if name == "coherent"
                       else "(uniform random)")
                    + f", CUDA events over {RATE_REPEATS} back-to-back "
                      "calls, mean; index read and output write included"))
    del coherent, rnd
    before = sc.score_partials.launches
    first = sc.score_partials(*args)
    k_ms = smoke.profiled_ms("sol_bound calcscore",
                             lambda: sc.score_partials(*args), first,
                             "score_partials_kernel")
    how = "the profiler's device ms a launch, mean of 50"
    if k_ms is None:     # the profiler's device events came back empty
        runs = []
        k_ms = smoke.time_cuda(lambda: runs.append(sc.score_partials(*args)),
                               200)
        if not all(torch.equal(a, b) for r in runs for a, b in zip(first, r)):
            raise RuntimeError("CalcScore's timed launches on the relock "
                               "frame are not bitwise equal")
        how = ("CUDA events over 200 back-to-back launches (the launch gaps "
               "included)")
    launch = dict(args=args, out=first,
                  launches=sc.score_partials.launches - before)
    rates["calcscore"] = dict(
        rate=cells.numel() / k_ms * 1e3, ms=k_ms, gathers=cells.numel(),
        method=(f"CalcScore on relock frame {f_relock}: {cells.numel()} "
                f"in-map cells of {nl} slots x {P} pixels over {how}"))
    best = max(rates, key=lambda k: rates[k]["rate"])
    out["gather_rate"] = dict(value=rates[best]["rate"], which=best,
                              rates=rates, relock_frame=f_relock)

    # --- H2D -----------------------------------------------------------
    nbytes = sum(np.asarray(v).nbytes for v in frames.values())
    ts = []
    for _ in range(H2D_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop.to_device(frames, dev)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    out["h2d_ms"] = dict(value=statistics.median(ts), method=(
        f"loop.to_device of the stacked frames ({nbytes} bytes, pageable "
        f"numpy), time to completion, median of {H2D_REPEATS}"))

    # --- loop floor ----------------------------------------------------
    floor = smoke.launch_floor_ms()
    out["loop_floor_ms"] = dict(value=F * floor, launch_floor_ms=floor,
                                method=(f"{F} frames x the launch floor "
                                        f"{floor:.6f} ms (the profiler's "
                                        "device time of a one-element "
                                        "add_)"))

    # --- featurize and UKF, as built -----------------------------------
    n = F if profile_frames is None else min(F, profile_frames)
    fr = loop.to_device({k: np.asarray(v)[:n] for k, v in frames.items()},
                        dev)
    inputs = [tuple(fr[k][f] for k in loop._FRAME_KEYS) for f in range(n)]
    ukf = [(state.kalman_x, state.kalman_P, o["scan_pose"], o["measurement"])
           for _fs, state, o in steps[:n]]
    scaled = "" if n == F else f", scaled from {n} profiled frames to {F}"
    fc = cfg.filter

    def busy(fn):
        # the profiler's device events can come back empty: take it again
        _wall, acts = smoke.device_profile(fn, bool)
        if not acts:
            raise RuntimeError("torch.profiler recorded no device activity")
        return (sum(v[1] for v in acts.values()) / 1e3,
                sum(v[0] for v in acts.values()))

    for key, fn, what in (
            ("featurize_ms",
             lambda: [loop.featurize_stage(i, ctx, cfg) for i in inputs],
             "loop.featurize_stage on each frame's inputs"),
            ("ukf_ms",
             lambda: [fukf.ukf_step(*u, alpha=fc.alpha, beta=fc.beta,
                                    kappa=fc.kappa, dt_step=fc.dt)
                      for u in ukf],
             "ukf_step on each frame's recorded filter inputs")):
        ms, ops = busy(fn)
        out[key] = dict(value=ms * F / n, device_ops=ops, method=(
            f"as built, not a bound: device-busy ms of {what} "
            f"(torch.profiler, chip_smoke.device_profile){scaled}"))
    return out, launch


def floors(counts, const):
    """{count: ms} of the achievable floor (the gather term at the
    chosen rate plus the other constants) for each of the three counts,
    and the gather term alone under "gather_ms"."""
    rate = const["gather_rate"]["value"]
    base = sum(const[k]["value"] for k in ("h2d_ms", "loop_floor_ms",
                                           "featurize_ms", "ukf_ms"))
    g = {k: float(counts[k].sum()) / rate * 1e3
         for k in ("as_chunked", "as_built", "useful")}
    return dict(gather_ms=g, floor_ms={k: base + v for k, v in g.items()})


def print_bound(const, fl, card):
    """The bottom line, as the reference script's, with each constant's
    method."""
    gr = const["gather_rate"]
    print(f"\ncard: {card}")
    for name, r in gr["rates"].items():
        print(f"  gather rate {name:9s}: {r['rate'] / 1e6:12.1f} M elem/s "
              f"({r['method']})")
    g = fl["gather_ms"]
    print(f"bound arithmetic @ {gr['value'] / 1e6:.1f} M elem/s (the "
          f"highest measured: {gr['which']}):")
    print(f"  scoring gather   : {g['as_chunked']:9.3f} ms (as chunked)  "
          f"/ {g['as_built']:.3f} ms (as the port gathers) "
          f"/ {g['useful']:.3f} ms (useful)")
    for key, label in (("h2d_ms", "+ H2D           "),
                       ("loop_floor_ms", "+ loop floor    "),
                       ("featurize_ms", "+ featurize     "),
                       ("ukf_ms", "+ UKF           ")):
        print(f"  {label} : {const[key]['value']:9.3f} ms "
              f"({const[key]['method']})")
    f = fl["floor_ms"]
    print(f"  = achievable floor {f['as_chunked']:.3f} ms as chunked / "
          f"{f['as_built']:.3f} ms as the port gathers / "
          f"{f['useful']:.3f} ms useful "
          "(assumes zero candgen/fuse/glue)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default=None,
                    help="dataset directory (default: data1 under "
                         "$LSDTPU_REFERENCE)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="'cuda' (default; exits 2 without a card) or "
                         "'cpu' (the counts only)")
    args = ap.parse_args(argv)

    import torch
    from lsdtpu_torch import resolve_device
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr, flush=True)
        return 2
    from lsdtpu_torch.bench import DATA, bench_cfg
    from lsdtpu_torch.io import load_dataset
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    data = args.data or DATA
    cfg = bench_cfg()
    ctx, frames = scene_context(load_dataset(data), np.float32, dev)
    steps = [] if dev.type == "cuda" else None
    t0 = time.perf_counter()
    recs = rollout_counts(frames, ctx, cfg, dev, steps=steps)
    secs = time.perf_counter() - t0
    counts = gather_counts(recs, cfg)
    print_counts(recs, counts)
    summary = dict(
        data=data, device=dev.type, frames=int(len(recs["live_cand"])),
        counts={k: int(counts[k].sum())
                for k in ("useful", "as_chunked", "as_built")},
        pruned_frames=int(counts["pruned"].sum()),
        counting_rollout_s=secs, card=None, constants=None, floor_ms=None)
    if dev.type != "cuda":
        print("\nconstants: not measured (they need a card: --device "
              "cuda); no bound on the CPU", flush=True)
    else:
        import chip_smoke as smoke
        card = smoke.nvidia_smi_line()
        const, _launch = measure_constants(frames, ctx, cfg, recs, smoke,
                                           steps)
        fl = floors(counts, const)
        print_bound(const, fl, card)
        summary.update(card=card, constants=const, **fl)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
