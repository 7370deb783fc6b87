#!/usr/bin/env python3
"""Device time of the PyTorch/CUDA port's two kernels (CalcScore,
csrc/score.cu; NFA count, csrc/nfa.cu) at the main path's cases, for the
checkout at --root, on one NVIDIA card.

    python3 scripts/torch_kernel_ab.py --root DIR --label NAME

lsdtpu_torch is imported from DIR and the case helpers from this
checkout's chip_smoke.py, so two checkouts (a parent and a change) are
measured by the same code at the same inputs.  Run them in turns in one
process per checkout, parent, change, change, parent, to compare them on
one card.  The cases: the launch floor (a one-element PyTorch elementwise
kernel); CalcScore at the relock and tracking frames of the synthetic
data1-sized scene on its wall segments (K cap 2048), pruned and
unpruned, and at the relock frame on the port's own f32 LSD lines with
the K cap 4096; the NFA count on three launches recorded from an f32
map prep (the most covered, the median R = 1, the median R = 5).  Each
case is checked against the plain version and for 50 bitwise-equal
repeats, as chip_smoke.py does.  The last line of the output is one JSON
object.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np

KEYS = ("name", "ms", "bound_ms", "plain_ms", "floor_ms", "live_candidates",
        "live_pixels", "k_cap", "rects", "covered_pairs")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose lsdtpu_torch is measured")
    ap.add_argument("--label", default="",
                    help="name printed with the results")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    here = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", here)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False", flush=True)
        sys.exit(2)
    import lsdtpu_torch
    from lsdtpu_torch.config import DEFAULT
    from lsdtpu_torch.io import synth
    from lsdtpu_torch.mapprep.distance import create_map_cache
    from lsdtpu_torch.mapprep.pipeline import prepare_map
    from lsdtpu_torch.runtime import loop
    if not Path(lsdtpu_torch.__file__).resolve().is_relative_to(root):
        cs.fail(f"lsdtpu_torch came from {lsdtpu_torch.__file__}, not {root}")
    device = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False

    floor_ms = cs.launch_floor_ms()
    scene = cs.make_scene()
    ds = scene.dataset
    resol = ds.param.resol
    cache64 = create_map_cache(ds.map_value, resol,
                               DEFAULT.map.z_occ_max_dis,
                               dtype=torch.float64, device=device)
    ctx = loop.make_map_context(synth.wall_lines(scene.walls), cache64,
                                resol, ds.param.ori_x, ds.param.ori_y,
                                dtype=np.float32, device=device)
    cases = cs.score_frame_cases(scene, ctx, DEFAULT, device, repr(smi),
                                 floor_ms)
    art, calls = cs.record_rect_counts(lambda: prepare_map(
        ds.map_value, resol, dtype=torch.float32, device=device))
    cases += cs.nfa_cases(calls, repr(smi), floor_ms)
    ctx_e = loop.make_map_context(art.lines_info, art.map_cache, resol,
                                  ds.param.ori_x, ds.param.ori_y,
                                  dtype=np.float32, device=device)
    cfg_e = dataclasses.replace(DEFAULT, shapes=dataclasses.replace(
        DEFAULT.shapes, max_candidates=4096))
    cases += cs.score_frame_cases(scene, ctx_e, cfg_e, device, repr(smi),
                                  floor_ms, prefix="e2e_",
                                  frames=("relock",))
    print(smi, flush=True)
    print(json.dumps({"label": args.label, "root": root, "card": smi,
                      "floor_ms": floor_ms, "nfa_launches": len(calls),
                      "cases": [{k: c[k] for k in KEYS if k in c}
                                for c in cases]}), flush=True)


if __name__ == "__main__":
    main()
