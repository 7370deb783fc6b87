#!/usr/bin/env python3
"""Randomized parity campaign of the PyTorch/CUDA port (lsdtpu_torch) on
synthetic scenes, on one NVIDIA card (or on the CPU when asked).

    python3 scripts/torch_fuzz_campaign.py [--cache 40] [--lsd 12]
        [--fifo 8] [--rollout 8] [--shard 4] [--seed0 100]
        [--device cuda|cpu]

The port of scripts/fuzz_campaign.py: the same synthetic scenes
(lsdtpu_torch/io/synth.py at its defaults: a 200x260 room at 0.05 m/px,
2-4 interior walls, 10 frames), the same seeds and the same contracts,
held against the port's own numpy oracle (lsdtpu_torch/oracle):

  1. mapCache: the port's distance field on the device bit-exact to the
     oracle's;
  2. LSD wave (f64 on the device): line count 0.7-2.0x the oracle's, at
     least 90% of its lines matched within 25 px and 70% within 2 px;
     tallies of the seeds whose lines are the oracle's array exactly and
     of those with its count and every line within 1e-9 px (either
     endpoint order);
  3. LSD FIFO (growth="fifo"): the same;
  4. f64 rollout on the oracle's map: identical decisions (tracked
     pattern, NaN-pose frames), then the strong tier (scores 1e-9,
     poses 1e-4 px) or the weak tier (_weak_tier_ok);
  5. sharded equality: two ranks over gloo (sharing the card on cuda)
     run shard.run_batch_sharded (tp) and run_batch_sharded_mapblocks
     (mp); the same finite pattern and poses within 1e-6 px of
     run_sequence.

and, where the device is the card, two contracts of the port's own:

  6. card = CPU in f64: each LSD seed's lines on the CPU row for row
     (endpoints within 1e-9 px), each rollout's n_candidates and finite
     pattern identical and poses within 1e-9 px;
  7. every kernel launch the sections make replayed through the plain
     version on the CPU: grow_fifo (region, queue and count bitwise,
     reg_deg within 1e-12, as chip_smoke.py holds it) and
     radius_reducer_fifo bitwise, the NFA counts exactly, the CalcScore
     partials (single-lane in this process, lane-batched in the ranks)
     with counts exact and sums within chip_smoke.py's RTOL/ATOL.  Each
     kernel's recorded launches must equal its wrapper's launch count,
     and a kernel that a section drove but that launched 0 times on the
     card is a failure (radius_reducer_fifo is driven where the CPU run
     of a FIFO map prep called its plain version: few regions of these
     maps need it).

A violation prints ``FAIL <section> seed=<n>: <diff>``; each section
prints one line with its seeds, tallies and seconds, and the run ends
with ``campaign done: N failures``, then one JSON object with every
section's counts, the launches held per kernel and ``failures``.
Returns 1 on any failure.  ``--device cuda`` (the default) without a
card exits 2 and runs nothing.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

LINE_TOL_PX = 1e-9      # lines within this of the oracle's / the CPU's
CARD_CPU_POSE_PX = 1e-9  # rollout poses, card vs CPU (f64)
REG_DEG_TOL = 1e-12     # grow_fifo's reg_deg, kernel vs plain (atan2)
KERNELS = ("score_partials", "rect_counts", "grow_fifo",
           "radius_reducer_fifo")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _weak_tier_ok(poses, oposes, ok_frames):
    """Boundary-amplified tier (the reference campaign's): transient
    divergence only.  Every difference on an ok frame stays under 5 px
    and the chain re-converges - the last (up to) 3 ok frames agree
    within 0.5 px."""
    idx = np.nonzero(ok_frames)[0]
    if len(idx) == 0:
        return True
    d = np.abs(poses[idx] - oposes[idx]).max(axis=1)
    tail = d[-min(3, len(d)):]
    return bool(d.max() < 5.0 and (tail < 0.5).all())


def structural_ok(got, want, match):
    """The reference's LSD contract: more than 4 oracle lines, a count
    0.7-2.0x the oracle's, >= 90% matched at 25 px and >= 70% at 2 px."""
    return (len(want) > 4
            and 0.7 * len(want) <= len(got) <= 2.0 * len(want)
            and match(got, want, 25.0) >= int(0.9 * len(want))
            and match(got, want, 2.0) >= int(0.7 * len(want)))


class Campaign:
    """Failures, per-section tallies and the held kernel launches."""

    def __init__(self, device, cs):
        import torch
        self.dev = device
        self.card = device.type == "cuda"
        self.cpu = torch.device("cpu")
        self.cs = cs
        self.fails = 0
        self.sections = {}
        self.held = {k: 0 for k in KERNELS}
        self.held["score_partials_batched"] = 0
        self.ran = {k: False for k in KERNELS}

    def fail(self, section, seed, diff):
        self.fails += 1
        print(f"FAIL {section} seed={seed}: {diff}", flush=True)

    # -- 7. every launch against its plain version -------------------
    def held_run(self, seed, run, kernels):
        """run() with the launches of ``kernels`` recorded on the card,
        then replayed through the plain versions on the CPU (grow_fifo
        brings radius_reducer_fifo, which only some regions need)."""
        import torch
        for k in kernels:
            self.ran[k] = True
        if not self.card:
            return run()
        cs = self.cs
        wrappers = _wrappers()
        before = {k: w.launches for k, w in wrappers.items()}
        rec = {}

        def layer(run, k):
            def go():
                if k == "score_partials":
                    out, rec[k] = cs.record_partials(run)
                elif k == "rect_counts":
                    out, rec[k] = cs.record_rect_counts(run)
                else:
                    out, rec[k], rec["radius_reducer_fifo"] = \
                        cs.record_fifo(run)
                return out
            return go

        for k in kernels:
            run = layer(run, k)
        out = run()
        torch.cuda.synchronize()
        for k, calls in rec.items():
            bad = sum(not ok for ok in _replay(cs, k, calls))
            launched = wrappers[k].launches - before[k]
            if launched != len(calls):
                self.fail(f"launch-{k}", seed, f"{len(calls)} launches "
                          f"recorded, the wrapper counted {launched}")
            if bad:
                self.fail(f"launch-{k}", seed, f"{bad} of {len(calls)} "
                          "launches differ from the plain version")
            self.held[k] += len(calls)
        return out

    def check_held(self):
        """Section 7's closing check: every kernel a section drove
        launched at least once on the card (the reducer where the plain
        run of the same map prep called it)."""
        if not self.card:
            return
        for k in KERNELS:
            n = self.held[k] + (self.held["score_partials_batched"]
                                if k == "score_partials" else 0)
            if self.ran[k] and n == 0:
                self.fail(f"launch-{k}", "all", "0 launches held on the card")


def _wrappers():
    from lsdtpu_torch.ops import grow as og
    from lsdtpu_torch.ops import nfa as onfa
    from lsdtpu_torch.ops import score as sc
    return dict(score_partials=sc.score_partials,
                rect_counts=onfa.rect_counts, grow_fifo=og.grow_fifo,
                radius_reducer_fifo=og.radius_reducer_fifo)


def _replay(cs, kernel, calls):
    """For each recorded launch of ``kernel``: True where the plain
    version on the CPU gives its outputs (within the kernel's tier)."""
    import torch
    from lsdtpu_torch.ops import nfa as onfa
    if kernel == "score_partials":
        for counts, sums, _err in map(cs.replay_partials, calls):
            yield counts and sums
    elif kernel == "rect_counts":
        maps = {}
        for deg_map, scal, all_pix, ali_pix, block in calls:
            m = maps.setdefault(id(deg_map), deg_map.cpu())
            want = onfa.rect_counts_reference(m, scal.cpu(), *block)
            yield (torch.equal(all_pix.cpu(), want[0])
                   and torch.equal(ali_pix.cpu(), want[1]))
    elif kernel == "grow_fifo":
        maps = tuple(calls[0][m].cpu() for m in ("deg", "sn", "cs")) \
            if calls else None
        for c in calls:
            same, rd = cs.replay_grow(c, maps)
            yield same and rd <= REG_DEG_TOL
    else:
        for c in calls:
            yield cs.replay_reduce(c)


def section_cache(cp, seeds):
    """1. the port's distance field on the device, bit-exact."""
    from lsdtpu_torch.io import synth
    from lsdtpu_torch.mapprep.distance import create_map_cache
    from lsdtpu_torch.oracle import lsd as olsd
    import torch
    t0 = time.time()
    for seed in seeds:
        g, _walls = synth.synth_map(seed)
        want = olsd.create_map_cache(g.copy(), synth.RESOL, 1.0)
        got = create_map_cache(g, synth.RESOL, 1.0, dtype=torch.float64,
                               device=cp.dev).cpu().numpy()
        if not np.array_equal(got, want):
            cp.fail("cache", seed, f"{(got != want).sum()} differing cells")
    s = time.time() - t0
    cp.sections["cache"] = dict(seeds=len(seeds), seconds=s)
    print(f"mapCache bit-exact: {len(seeds)} seeds, {s:.1f}s", flush=True)


def section_lsd(cp, seeds, growth):
    """2./3. the port's f64 LSD on the device against the oracle's lines
    (the structural contract, the tallies), and against the CPU's."""
    import torch
    from lsdtpu_torch.io import synth
    from lsdtpu_torch.mapprep.lsd import line_segment_detector
    from lsdtpu_torch.oracle import lsd as olsd
    match = cp.cs.match_lines
    tag = f"lsd-{growth}"
    kernels = ("rect_counts",) + (("grow_fifo",) if growth == "fifo"
                                  else ())

    def lines(g, dev):
        infos, mask, _n, _rm = line_segment_detector(
            g.astype(np.float64), growth=growth, dtype=torch.float64,
            device=dev)
        return infos[mask].cpu().numpy()

    t0 = time.time()
    exact = within = in_order = card_cpu = 0
    order_px = cpu_px = 0.0
    for seed in seeds:
        g, _walls = synth.synth_map(seed)
        want = olsd.line_segment_detector(g.copy()).lines_info
        got = cp.held_run(seed, lambda: lines(g, cp.dev), kernels)
        if got.shape == want.shape and np.array_equal(got, want):
            exact += 1
        if len(got) == len(want) and match(got, want, LINE_TOL_PX) == \
                len(want):
            within += 1
            # the oracle's row order, or another: the rows read in order
            d = float(np.abs(got[:, 4:8] - want[:, 4:8]).max(initial=0.0))
            if d <= LINE_TOL_PX:
                in_order += 1
                order_px = max(order_px, d)
        if not structural_ok(got, want, match):
            cp.fail(tag, seed, f"oracle {len(want)} vs port {len(got)} "
                    f"lines, 25px-matched {match(got, want, 25.0)}")
        if cp.card:
            cpu, _grows, reduces = cp.cs.record_fifo(lambda: lines(g, cp.cpu))
            # the reducer is this section's kernel where a region needs it
            cp.ran["radius_reducer_fifo"] |= bool(reduces)
            d = (float(np.abs(got[:, 4:8] - cpu[:, 4:8]).max(initial=0.0))
                 if len(got) == len(cpu) else np.inf)
            if not d <= LINE_TOL_PX:
                cp.fail(f"card-cpu-{tag}", seed, f"{len(got)} lines on the "
                        f"card, {len(cpu)} on the CPU, max endpoint diff "
                        f"{d} px")
            else:
                card_cpu += 1
                cpu_px = max(cpu_px, d)
    s = time.time() - t0
    cp.sections[tag] = dict(seeds=len(seeds), bitwise=exact,
                            within_1e9=within, oracle_order=in_order,
                            oracle_order_max_px=order_px, seconds=s,
                            card_cpu=card_cpu if cp.card else None,
                            card_cpu_max_px=cpu_px if cp.card else None)
    name = "LSD wave structural" if growth == "wave" else "LSD fifo"
    print(f"{name}: {len(seeds)} seeds ({exact} bitwise-identical, "
          f"{within} same count within {LINE_TOL_PX:g} px, {in_order} in "
          f"the oracle's row order with endpoints within {order_px:.3g} px"
          + (f", {card_cpu} card = CPU within {cpu_px:.3g} px" if cp.card
             else "")
          + f"), {s:.1f}s", flush=True)


def scene_inputs(seed):
    """A seed's synthetic dataset, the oracle's map artifacts and the
    f64 frames."""
    from lsdtpu_torch.io import synth
    from lsdtpu_torch.oracle import driver as odrv
    from lsdtpu_torch.runtime import loop
    ds = synth.synth_dataset(seed).dataset
    art = odrv.prepare_map(ds.map_value.copy(), ds.param.resol)
    p = ds.param
    return (ds, art, (art.lines_info, art.map_cache, p.resol, p.ori_x,
                      p.ori_y), loop.stack_frames(ds, dtype=np.float64))


def rollout(mp, frames, dev):
    from lsdtpu_torch.config import DEFAULT
    from lsdtpu_torch.runtime import loop
    ctx = loop.make_map_context(*mp, dtype=np.float64, device=dev)
    outs = loop.run_sequence(frames, ctx, DEFAULT, device=dev)
    return {k: outs[k].cpu().numpy()
            for k in ("pose", "score", "n_candidates")}


def section_rollout(cp, seeds):
    """4. f64 rollouts on the oracle's map against the oracle's run (the
    decisions, then the strong or the weak tier), and against the CPU."""
    from lsdtpu_torch.oracle import driver as odrv
    t0 = time.time()
    strong = weak = card_cpu = 0
    cpu_px = oracle_px = 0.0
    for seed in seeds:
        ds, art, mp, frames = scene_inputs(seed)
        ores = odrv.run_sequence(ds, map_art=art)
        out = cp.held_run(seed, lambda: rollout(mp, frames, cp.dev),
                          ("score_partials",))
        sc, poses = out["score"], out["pose"]
        osc = np.array([r.score for r in ores.records])
        decisions = (np.array_equal(np.isfinite(sc), np.isfinite(osc))
                     and np.array_equal(np.isnan(poses).any(1),
                                        np.isnan(ores.poses).any(1)))
        ok_frames = np.isfinite(osc) & ~np.isnan(ores.poses).any(1)
        oracle_px = max(oracle_px, float(np.abs(
            poses[ok_frames] - ores.poses[ok_frames]).max(initial=0.0)))
        if decisions and np.allclose(sc[ok_frames], osc[ok_frames],
                                     atol=1e-9) \
                and np.allclose(poses[ok_frames], ores.poses[ok_frames],
                                atol=1e-4):
            strong += 1
        elif decisions and _weak_tier_ok(poses, ores.poses, ok_frames):
            weak += 1
        else:
            d = np.nanmax(np.abs(poses - ores.poses))
            cp.fail("rollout", seed, f"decisions={decisions} max pose diff "
                    f"{d}")
        if cp.card:
            cpu = rollout(mp, frames, cp.cpu)
            same = (np.array_equal(out["n_candidates"], cpu["n_candidates"])
                    and np.array_equal(np.isfinite(sc),
                                       np.isfinite(cpu["score"]))
                    and np.array_equal(np.isnan(poses),
                                       np.isnan(cpu["pose"])))
            d = float(np.nanmax(np.abs(poses - cpu["pose"]), initial=0.0))
            if not (same and d <= CARD_CPU_POSE_PX):
                cp.fail("card-cpu-rollout", seed, f"decisions identical "
                        f"{same}, max pose diff {d} px")
            else:
                card_cpu += 1
                cpu_px = max(cpu_px, d)
    s = time.time() - t0
    cp.sections["rollout"] = dict(
        seeds=len(seeds), strong=strong, weak=weak,
        oracle_max_px=oracle_px, seconds=s,
        card_cpu=card_cpu if cp.card else None,
        card_cpu_max_px=cpu_px if cp.card else None)
    print(f"f64 rollout vs oracle: {len(seeds)} seeds ({strong} strong-tier, "
          f"{weak} boundary-amplified weak-tier, poses within "
          f"{oracle_px:.3g} px on the oracle's ok frames"
          + (f", {card_cpu} card = CPU within {cpu_px:.3g} px" if cp.card
             else "")
          + f"), {s:.1f}s", flush=True)


def section_shard(cp, seeds):
    """5. tp = 2 and mp = 2 on two ranks against run_sequence."""
    t0 = time.time()
    cases, refs = [], []
    for seed in seeds:
        _ds, _art, mp, frames = scene_inputs(seed)
        cases.append(dict(map=mp, frames=frames))
        refs.append(cp.held_run(seed, lambda: rollout(mp, frames, cp.dev),
                                ("score_partials",)))
    ranks, max_px = [], 0.0
    if cases:
        drift = _load("torch_sharded_drift",
                      ROOT / "scripts" / "torch_sharded_drift.py")
        ranks, _s = drift.run_ranks(cases, cp.dev)
    for i, seed in enumerate(seeds):
        ref = refs[i]
        for name, tag in (("dp-tp", "tp2"), ("dp-mp", "mp2")):
            res = [r[i][tag] for r in ranks]
            ok = all(np.array_equal(np.isfinite(x["score"]),
                                    np.isfinite(ref["score"]))
                     and np.allclose(x["pose"], ref["pose"], atol=1e-6,
                                     equal_nan=True) for x in res)
            d = max(float(np.nanmax(np.abs(x["pose"] - ref["pose"]),
                                    initial=0.0)) for x in res)
            max_px = max(max_px, d)
            if not ok:
                cp.fail(f"shard-{name}", seed, f"max pose diff {d}")
            held = sum(x["held"] for x in res)
            differ = sum(x["differ"] for x in res)
            if differ:
                cp.fail("launch-score_partials_batched", seed,
                        f"{differ} of {held} launches of the {tag} ranks "
                        "differ from the plain version")
            cp.held["score_partials_batched"] += held
    s = time.time() - t0
    cp.sections["shard"] = dict(seeds=len(seeds), meshes=2, max_px=max_px,
                                seconds=s)
    print(f"sharded-runtime equality: {len(seeds)} seeds x 2 meshes (poses "
          f"within {max_px:.3g} px of run_sequence), {s:.1f}s", flush=True)


def campaign(argv=None):
    """Run the campaign with ``argv``'s flags; returns (exit code, the
    summary the last line prints), the summary None without a card."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cache", type=int, default=40)
    ap.add_argument("--lsd", type=int, default=12)
    ap.add_argument("--fifo", type=int, default=8)
    ap.add_argument("--rollout", type=int, default=8)
    ap.add_argument("--shard", type=int, default=4)
    ap.add_argument("--seed0", type=int, default=100,
                    help="first seed (the tests use 0-4; default starts "
                         "past)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the port runs: 'cuda' (default; exits 2 "
                         "without a card) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)

    import torch
    from lsdtpu_torch import resolve_device
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr, flush=True)
        return 2, None
    cs = _load("chip_smoke_cases", ROOT / "chip_smoke.py")
    cp = Campaign(dev, cs)
    s0 = args.seed0
    t_all = time.time()
    section_cache(cp, range(s0, s0 + args.cache))
    section_lsd(cp, range(s0, s0 + args.lsd), "wave")
    section_lsd(cp, range(s0, s0 + args.fifo), "fifo")
    section_rollout(cp, range(s0, s0 + args.rollout))
    section_shard(cp, range(s0, s0 + max(0, args.shard)))
    cp.check_held()
    held = " ".join(f"{k}={v}" for k, v in cp.held.items())
    print(f"launches held against the plain versions: "
          f"{held if cp.card else 'none (no kernel runs on the CPU)'}",
          flush=True)
    print(f"campaign done: {cp.fails} failures", flush=True)
    summary = dict(
        device=str(dev), kind=(torch.cuda.get_device_name(dev)
                               if cp.card else "cpu"),
        seed0=s0, sections=cp.sections, launches_held=cp.held,
        seconds=time.time() - t_all, failures=cp.fails)
    print(json.dumps(summary), flush=True)
    return (1 if cp.fails else 0), summary


def main(argv=None) -> int:
    return campaign(argv)[0]


if __name__ == "__main__":
    raise SystemExit(main())
