#!/usr/bin/env python3
"""Scale-out measurement of the port: one command, one SCALING json
(counterpart of scripts/pod_bench.py).

    python3 scripts/torch_pod_bench.py [--data DIR] [--frames N]
        [--repeats N] [--n-devices N] [--modes solo,dp,serving,temporal]
        [--out PATH] [--dry] [--device cuda|cpu] [--init-method URL]
    torchrun --nproc-per-node W scripts/torch_pod_bench.py ...   # W ranks

Measures, time to value (every repeat synchronizes and reads its outputs
to the host), on the numpy oracle's map of the dataset (f32):

  solo      - runtime/loop.run_sequence on this rank's device (scans/s);
  dp        - runtime/shard.run_batch_sharded over a (dp=W, tp=1) mesh,
              B = W copies of the sequence, one lane a rank (the runner
              takes the host-replicated batch and gives each rank its
              shard, as distributed.globalize_batch does);
  serving   - runtime/serving.SessionPool(capacity=W) over
              make_pool_mesh(W): W sessions ticking in lockstep, the
              host-side packing included, every session closed and
              reopened before each repeat (a fresh slot state and
              odometry chain: a stale one would feed frame 0's odometry
              against the previous repeat's last frame and force a
              relock);
  temporal  - runtime/temporal.run_sequence_temporal over
              make_mesh_sp(W): one trajectory cut into W segments;

and writes {"solo": {...}, "dp": {...}, ...} with scans/s, medians and
efficiency against solo to --out (default SCALING_<device type>.json),
the reference script's keys, with "backend" the device type and two
more: "card" (nvidia-smi's name and power limit of this rank's card,
null on the CPU) and "dist_backend" (the process group's backend, null
where no mode needed one).

World size 1 is one process; dp, serving and temporal run on a one-rank
group (gloo on the CPU, NCCL on the card).  World size W > 1 runs under
torchrun's environment (WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE
and MASTER_ADDR / MASTER_PORT, or ``--init-method`` such as a file://
store): runtime/distributed.initialize starts the group with the port's
own choice of backend, gloo where ranks share a card and NCCL where each
has one.  Every mode runs across the ranks: the reference script runs
serving and temporal in one process only, and the port's runners take
both across ranks.  ``--n-devices`` chooses nothing: the world size is
the mesh (one mesh position a rank), and the flag, kept for command-line
parity with the reference script, only checks it.  Rank 0 writes the
json.

Ranks that share one card (or the CPU) contend for it: their numbers
check the plumbing and do not measure scaling.  ``--device cuda`` (the
default) without a card exits 2.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _timed(fn, repeats, setup=None):
    """Median-of-repeats wall time of fn() and each repeat's result;
    ``setup`` runs before every repeat outside the timed region (e.g.
    resetting the serving sessions, so that each repeat replays the same
    workload)."""
    ts, vals = [], []
    for _ in range(repeats):
        if setup is not None:
            setup()
        t0 = time.perf_counter()
        vals.append(fn())
        ts.append(time.perf_counter() - t0)
    return {"median_s": statistics.median(ts), "min_s": min(ts),
            "max_s": max(ts), "n_repeats": repeats}, vals


def card_line(device):
    """nvidia-smi's "name, power limit" of ``device``'s card, or None."""
    import torch
    if device.type != "cuda":
        return None
    res = subprocess.run(
        ["nvidia-smi", f"--id={torch.cuda.current_device()}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    lines = res.stdout.strip().splitlines()
    return lines[0] if res.returncode == 0 and lines else None


class Bench:
    """The run's inputs: the parsed flags, the device, the world, the
    dataset, its oracle map artifacts, the map context and the frames."""

    def __init__(self, args, dev, world):
        from lsdtpu_torch.config import DEFAULT
        from lsdtpu_torch.io import load_dataset
        from lsdtpu_torch.oracle import driver as odrv
        from lsdtpu_torch.runtime import loop
        self.args, self.dev, self.world = args, dev, world
        self.cfg = DEFAULT
        self.ds = load_dataset(args.data)
        p = self.ds.param
        self.art = odrv.prepare_map(self.ds.map_value, p.resol)
        self.params = (p.resol, p.ori_x, p.ori_y)
        self.ctx = loop.make_map_context(self.art.lines_info,
                                         self.art.map_cache, *self.params,
                                         device=dev)
        self.frames = loop.stack_frames(self.ds, max_frames=args.frames)
        self.F = self.frames["ranges"].shape[0]


def mode_solo(b):
    from lsdtpu_torch.runtime import loop

    def solo():
        return loop.run_sequence(b.frames, b.ctx, b.cfg,
                                 device=b.dev)["pose"].cpu().numpy()
    solo()   # warm-up (kernel build)
    r, vals = _timed(solo, b.args.repeats)
    return dict(r, scans_per_sec=b.F / r["median_s"]), vals


def mode_dp(b, solo_sps):
    from lsdtpu_torch.runtime import batch, shard
    n = b.world
    mesh = shard.make_mesh(n_devices=n, dp=n, device=b.dev)   # (dp=n, tp=1)
    bf = {k: np.broadcast_to(v, (n,) + v.shape).copy()
          for k, v in b.frames.items()}
    bctx = batch.batch_context(
        [(b.art.lines_info, b.art.map_cache)] * n, [b.params] * n, b.cfg,
        device="cpu")

    def dp():
        return shard.run_batch_sharded(bf, bctx, mesh, b.cfg,
                                       device=b.dev)["pose"].cpu().numpy()
    dp()
    r, vals = _timed(dp, b.args.repeats)
    sps = n * b.F / r["median_s"]
    return dict(r, scans_per_sec=sps, n_sequences=n,
                efficiency_vs_solo=(sps / (solo_sps * n)) if solo_sps
                else None), vals


def mode_serving(b, solo_sps):
    """The serving mode's result and each repeat's poses ({session:
    (ticks, 3)})."""
    from lsdtpu_torch.runtime.serving import SessionPool, make_pool_mesh
    n = b.world
    pool = SessionPool(n, b.art.map_cache.shape, cfg=b.cfg, device=b.dev,
                       mesh=make_pool_mesh(n, device=b.dev))
    margs = (b.art.lines_info, b.art.map_cache) + b.params
    sids = [f"s{i}" for i in range(n)]
    opened = set()

    def reset_sessions():
        for sid in sids:
            if sid in opened:
                pool.close_session(sid)
            pool.open_session(sid, *margs)
            opened.add(sid)

    ds = b.ds
    nf = min(b.F, len(ds.frames), ds.odom.shape[0] - 1)

    def serve():
        ticks = []
        for f in range(nf):
            fr = ds.frames[f]
            for sid in sids:
                pool.submit_scan(sid, fr[:, 0], fr[:, 1], ds.odom[f + 1])
            ticks.append(pool.step())      # numpy, read on the host
        return {s: np.stack([t[s]["pose"] for t in ticks]) for s in sids}
    reset_sessions()
    serve()
    r, vals = _timed(serve, b.args.repeats, setup=reset_sessions)
    sps = n * nf / r["median_s"]
    return dict(r, scans_per_sec=sps, n_sessions=n, frames=nf,
                efficiency_vs_solo=(sps / (solo_sps * n)) if solo_sps
                else None), vals


def mode_temporal(b, solo_sps):
    """The temporal mode's result, or (None, reason) where the sequence
    is too short for the segments and their warmup."""
    from lsdtpu_torch.runtime.temporal import (make_mesh_sp,
                                               run_sequence_temporal)
    n = b.world
    mesh = make_mesh_sp(n, device=b.dev)
    warmup = 8 if b.args.dry else 24
    if b.F <= n * (warmup + 4):
        return None, (f"sequence too short for {n} segments + warmup "
                      f"{warmup}")

    def temporal():
        return run_sequence_temporal(b.frames, b.ctx, mesh, b.cfg,
                                     warmup=warmup, device=b.dev)["pose"]
    temporal()
    r, vals = _timed(temporal, b.args.repeats)
    sps = b.F / r["median_s"]
    return dict(r, scans_per_sec=sps, n_segments=n, warmup=warmup,
                speedup_vs_solo=(sps / solo_sps) if solo_sps
                else None), vals


def parse(argv=None):
    from lsdtpu_torch.bench import DATA
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default=DATA)
    ap.add_argument("--frames", type=int, default=None,
                    help="cap frames per sequence (default: full)")
    ap.add_argument("--repeats", type=int, default=None,
                    help="timing repeats (default 3; 1 under --dry; "
                         "an explicit value is always honored)")
    ap.add_argument("--n-devices", type=int, default=None,
                    help="for parity with the reference script: "
                         "checks the world size, which is the mesh size")
    ap.add_argument("--modes", default="solo,dp,serving,temporal")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="'cuda' (default; exits 2 without a card) or "
                         "'cpu' (plumbing validation)")
    ap.add_argument("--init-method", default=None,
                    help="the process group's rendezvous at world size > 1 "
                         "(default env://: MASTER_ADDR, MASTER_PORT)")
    ap.add_argument("--dry", action="store_true",
                    help="12 frames + 1 repeat unless given (plumbing "
                         "check)")
    args = ap.parse_args(argv)
    if args.repeats is None:
        args.repeats = 1 if args.dry else 3
    if args.dry and args.frames is None:
        args.frames = 12
    return args


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    import torch.distributed as dist
    from lsdtpu_torch import resolve_device
    from lsdtpu_torch.runtime import distributed
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr, flush=True)
        return 2
    if dev.type == "cuda":
        # the UKF's float32 matmuls run in full precision (ukf_step asserts)
        torch.backends.cuda.matmul.allow_tf32 = False
    started = distributed.initialize(init_method=args.init_method,
                                     device=dev)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if args.n_devices is not None and args.n_devices != world:
        print(f"error: --n-devices {args.n_devices}: the world has {world} "
              "ranks (one mesh position a rank)", file=sys.stderr,
              flush=True)
        return 2
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    b = Bench(args, dev, world)
    results = {"backend": dev.type, "n_devices": world,
               "n_processes": world, "frames": b.F, "data": args.data,
               "dry": bool(args.dry), "card": card_line(dev)}

    solo_sps = None
    if "solo" in modes:
        results["solo"], _ = mode_solo(b)
        r = results["solo"]
        solo_sps = r["scans_per_sec"]
        print(f"solo     : {r['median_s']*1e3:8.1f} ms  "
              f"{solo_sps:9.1f} scans/s", flush=True)
    if "dp" in modes:
        results["dp"], _ = mode_dp(b, solo_sps)
        r = results["dp"]
        print(f"dp x{world:<4d}: {r['median_s']*1e3:8.1f} ms  "
              f"{r['scans_per_sec']:9.1f} scans/s aggregate", flush=True)
    if "serving" in modes:
        results["serving"], _ = mode_serving(b, solo_sps)
        r = results["serving"]
        print(f"serve x{world:<2d}: {r['median_s']*1e3:8.1f} ms  "
              f"{r['scans_per_sec']:9.1f} scans/s aggregate", flush=True)
    if "temporal" in modes:
        r, vals = mode_temporal(b, solo_sps)
        if r is None:
            print(f"temporal : skipped ({vals})", flush=True)
        else:
            results["temporal"] = r
            print(f"temporal : {r['median_s']*1e3:8.1f} ms  "
                  f"{r['scans_per_sec']:9.1f} scans/s (single trajectory)",
                  flush=True)

    results["dist_backend"] = (dist.get_backend() if dist.is_initialized()
                               else None)
    out = args.out or f"SCALING_{dev.type}.json"
    if rank == 0:
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {out}", flush=True)
    if started is not None:
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
