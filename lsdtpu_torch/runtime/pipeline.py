"""Pipeline parallelism: scan featurization and matching on two ranks,
overlapped across consecutive frames (counterpart of
lsdtpu/runtime/pipeline.py).

The reference runs its pipeline (L3 FeatureScan -> L4
FeatureAssociation) serially per frame.  Here the two stages run on the
two ranks of a ``pp`` mesh with a one-frame skew: at step s rank 0
featurizes frame s while rank 1 matches frame s - 1 (candidates,
scoring, fusion and the UKF), and the ScanFeatures of frame s (a few KB,
packed into one float64 buffer, which holds its int32, bool and float
fields exactly) cross to rank 1 in one collective a step.  The stages
are gated by plain ``if rank == ...``: each rank runs only its own
stage's work.  Rank 1 starts matching at step 1, so no warm-up step
advances its TrackState.

Outputs are those of the sequential rollout bit for bit (the skew
changes where featurization runs, not its inputs), at one step of extra
latency; every rank returns them.  As in the reference package this is a
demonstration of the dataflow: featurization is far cheaper than
matching, so two stages do not double throughput.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from lsdtpu_torch import resolve_device
from lsdtpu_torch.config import DEFAULT, EngineConfig
from lsdtpu_torch.runtime.collectives import Axis
from lsdtpu_torch.runtime.distributed import device_mesh, ensure_group
from lsdtpu_torch.runtime.loop import (_FRAME_KEYS, MapContext,
                                       featurize_stage, init_state,
                                       match_stage, prepare_coarse,
                                       reset_carry, to_device)
from lsdtpu_torch.scan.featurize import ScanFeatures

PP_AXIS = "pp"


def make_mesh_pp(device="cuda"):
    """1-D (pp,) mesh of the two ranks of the default group."""
    ensure_group(device)
    n = dist.get_world_size()
    if n != 2:
        raise ValueError("pipeline parallelism needs 2 ranks (have "
                         f"{n})")
    return device_mesh(device, (2,), (PP_AXIS,))


def _pack(fs: ScanFeatures) -> torch.Tensor:
    return torch.cat([getattr(fs, f.name).reshape(-1).to(torch.float64)
                      for f in dataclasses.fields(ScanFeatures)])


def _unpack(buf: torch.Tensor, like: ScanFeatures) -> ScanFeatures:
    parts, i = [], 0
    for f in dataclasses.fields(ScanFeatures):
        t = getattr(like, f.name)
        n = t.numel()
        parts.append(buf[i:i + n].reshape(t.shape).to(t.dtype))
        i += n
    return ScanFeatures(*parts)


def run_sequence_pipelined(frames, ctx: MapContext, mesh,
                           cfg: EngineConfig = DEFAULT, device="cuda"):
    """Two-stage pipelined rollout over a (pp,) mesh (make_mesh_pp);
    returns run_sequence's outputs ((F, ...) tensors on ``device``), the
    same on both ranks.  frames: dict of (F, ...) stacked inputs; ctx on
    ``device`` (both ranks hold the map).  Featurizes frame by frame:
    cfg's prefeaturize and scan_unroll are ignored."""
    dev = resolve_device(device)
    pp = Axis.of(mesh, PP_AXIS)
    fr = to_device(frames, dev)
    F = fr["ranges"].shape[0]
    frame = [{k: v[f] for k, v in fr.items()} for f in range(F)]
    # the ScanFeatures layout, for the packed buffer's shapes and types
    like = featurize_stage(tuple(frame[0][k] for k in _FRAME_KEYS), ctx,
                           cfg)
    zeros = torch.zeros_like(_pack(like))
    state = init_state(fr["ranges"].dtype, dev)
    coarse = prepare_coarse(ctx, cfg) if pp.index == 1 else None
    fs_prev, outs = None, []
    for s in range(F + 1):
        send = zeros
        if pp.index == 0 and s < F:
            send = _pack(featurize_stage(
                tuple(frame[s][k] for k in _FRAME_KEYS), ctx, cfg))
        if pp.index == 1 and s > 0:
            fr_s = frame[s - 1]
            state = reset_carry(state, fr_s)
            state, out = match_stage(
                state, fs_prev, tuple(fr_s[k] for k in _FRAME_KEYS), ctx,
                cfg, coarse=coarse)
            outs.append(out)
        if s < F:
            fs_prev = _unpack(pp.shift_next(send), like)
    # rank 1 holds the outputs: one host copy, sent to every rank
    got = [{k: torch.stack([o[k] for o in outs]).cpu().numpy()
            for k in outs[0]} if outs else None]
    dist.broadcast_object_list(got, src=dist.get_global_rank(pp.group, 1),
                               group=pp.group)
    return {k: torch.from_numpy(v).to(dev) for k, v in got[0].items()}
