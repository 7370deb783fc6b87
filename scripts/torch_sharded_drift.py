#!/usr/bin/env python3
"""How far the port's tp = 2 and mp = 2 rollouts drift from run_sequence
on chip_smoke.py's seed-1 scene in f64: two ranks over gloo, on the CPU
(the default) or sharing one card.

    python3 scripts/torch_sharded_drift.py [--frames 60] [--device cpu]

Two rank processes of this file join a gloo group through a file store
in a temporary directory, run shard.run_batch_sharded (tp) and
shard.run_batch_sharded_mapblocks (mp) over one lane of the scene's
frames, and pickle their outputs; this process holds them against
run_sequence on the same inputs (the scene's wall lines and its f64
distance field).  For each run it prints the largest pose difference
over the first 12 frames (tests/test_runtime_parallel.py's length) and
over all frames, the first frame past 1e-9 px, whether the
n_candidates are equal and, on the card, how many of the ranks'
lane-batched CalcScore launches were replayed through the plain version
on the CPU and how many differed.  The last line of the output is one
JSON object.  ``run_ranks`` (the rank processes) also serves
scripts/torch_fuzz_campaign.py's sharded section.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
REF_FRAMES = 12          # tests/test_runtime_parallel.py's NF
TIMEOUT_S = 1800.0


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_cases",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


RUNS = (("tp2", "make_mesh", "run_batch_sharded"),
        ("mp2", "make_mesh_mp", "run_batch_sharded_mapblocks"))


def rank_main(tmp, rank):
    """One rank: both sharded rollouts of each pickled case.  On the card
    every lane-batched CalcScore launch is recorded and replayed through
    the plain version on the CPU (chip_smoke.py's record_partials)."""
    import torch
    import torch.distributed as dist
    from lsdtpu_torch.config import DEFAULT
    from lsdtpu_torch.runtime import batch, distributed, shard
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    dev = torch.device(inp["device"])
    if dev.type == "cpu":
        torch.set_num_threads(inp["threads"])
    distributed.initialize(
        init_method="file://" + os.path.join(tmp, "store"), world_size=2,
        rank=rank, backend="gloo", device=dev, timeout_s=TIMEOUT_S)
    cs = chip_smoke()
    meshes = {tag: getattr(shard, make)(dp=1, device=dev)
              for tag, make, _run in RUNS}
    res = []
    for case in inp["cases"]:
        lines, cache, *params = case["map"]
        ctxs = batch.batch_context([(lines, cache)], [params], DEFAULT,
                                   dtype=np.float64, device="cpu")
        frames = {k: v[None] for k, v in case["frames"].items()}
        out = {}
        for tag, _make, run in RUNS:
            outs, calls = cs.record_partials(
                lambda: getattr(shard, run)(frames, ctxs, meshes[tag],
                                            DEFAULT, device=dev),
                "score_partials_batched")
            out[tag] = {k: outs[k][0].cpu().numpy()
                        for k in ("pose", "score", "n_candidates")}
            agree = [cs.replay_partials(c) for c in calls]
            out[tag].update(held=len(calls), differ=sum(
                not (counts and sums) for counts, sums, _e in agree),
                max_abs_err=max((e for _c, _s, e in agree), default=0.0))
        res.append(out)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


def run_ranks(cases, device, threads=2):
    """Both sharded rollouts of every case ({"map": (lines, cache, resol,
    ori_x, ori_y), "frames": stack_frames output}) on two rank processes
    of this file; returns ([rank 0's results, rank 1's], seconds), a
    result a case: {run: {pose, score, n_candidates, held, differ,
    max_abs_err}}."""
    tmp = tempfile.mkdtemp(prefix="lsdtpu_torch_drift_")
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
            pickle.dump(dict(cases=cases, device=str(device),
                             threads=threads), f)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", tmp,
             str(r)], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            logs = [q.communicate(timeout=TIMEOUT_S)[0] for q in procs]
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.communicate()
        for r, q in enumerate(procs):
            if q.returncode != 0:
                raise RuntimeError(f"rank {r} exited {q.returncode}: "
                                   f"{logs[r][-3000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        return ranks, time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=60,
                    help="frames of the rollouts (chip_smoke.py's 60)")
    ap.add_argument("--device", default="cpu",
                    help="the ranks' and run_sequence's device")
    ap.add_argument("--threads", type=int, default=2,
                    help="torch threads of each CPU process")
    ap.add_argument("--rank", nargs=2, metavar=("DIR", "RANK"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.rank:
        rank_main(args.rank[0], int(args.rank[1]))
        return
    import torch
    from lsdtpu_torch.config import DEFAULT
    from lsdtpu_torch.io import synth
    from lsdtpu_torch.mapprep.distance import create_map_cache
    from lsdtpu_torch.runtime import loop
    dev = torch.device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(args.threads)
    cs = chip_smoke()
    scene = cs.make_scene()
    ds = scene.dataset
    p = ds.param
    cache = create_map_cache(ds.map_value, p.resol, DEFAULT.map.z_occ_max_dis,
                             dtype=torch.float64, device=dev).cpu().numpy()
    lines = np.asarray(synth.wall_lines(scene.walls))
    fr = loop.stack_frames(ds, dtype=np.float64, max_frames=args.frames)
    case = dict(map=(lines, cache, p.resol, p.ori_x, p.ori_y), frames=fr)
    ctx = loop.make_map_context(*case["map"], dtype=np.float64, device=dev)
    t0 = time.perf_counter()
    seq = loop.run_sequence(fr, ctx, DEFAULT, device=dev)
    seq = {k: seq[k].cpu().numpy() for k in ("pose", "n_candidates")}
    seq_s = time.perf_counter() - t0
    try:
        ranks, ranks_s = run_ranks([case], args.device, args.threads)
    except RuntimeError as e:
        sys.exit(str(e))
    ranks = [r[0] for r in ranks]

    runs = []
    for tag in ("tp2", "mp2"):
        d = np.max([np.abs(res[tag]["pose"] - seq["pose"]).max(-1)
                    for res in ranks], 0)
        past = np.nonzero(d > 1e-9)[0]
        run = dict(run=tag, device=args.device, frames=args.frames,
                   max_px_first_12=float(d[:REF_FRAMES].max()),
                   max_px=float(d.max()),
                   first_frame_past_1e9=int(past[0]) if len(past) else None,
                   n_candidates_equal=all(np.array_equal(
                       res[tag]["n_candidates"], seq["n_candidates"])
                       for res in ranks),
                   launches_held=sum(res[tag]["held"] for res in ranks),
                   launches_differ=sum(res[tag]["differ"] for res in ranks))
        print(" ".join(f"{k}={v}" for k, v in run.items()), flush=True)
        runs.append(run)
    print(json.dumps({"runs": runs, "run_sequence_s": seq_s,
                      "ranks_s": ranks_s}), flush=True)


if __name__ == "__main__":
    main()
