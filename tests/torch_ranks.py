"""Rank processes of the port's multi-rank tests (tests/test_torch_*.py
that hold lsdtpu_torch's sharded runners against the JAX package).

Not collected by pytest (no ``test_`` prefix).  ``Group`` (or
``run_group``, which waits for it) writes the jobs' inputs to a
directory, starts ``world`` processes of this file
(``python torch_ranks.py DIR RANK WORLD``), each of which joins a gloo
process group through a file store in DIR (no port, so concurrent test
workers never collide), runs every job in order and pickles its results
to DIR/rank<R>.pkl.  The group has a timeout and the parent a join
timeout, so a hang fails one test.  This file imports only lsdtpu_torch,
never jax.
"""

import os
import pickle
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 60.0


class Group:
    """``world`` rank processes running ``jobs`` (a list of (job name,
    kwargs)); the caller works on while they run and reads ``results()``
    (each rank's list of job results), which raises when a rank failed
    or the group outlived ``timeout_s``."""

    def __init__(self, tmp_dir, world: int, jobs, timeout_s: float = 240.0):
        self.dir = str(tmp_dir)
        self.world = world
        with open(os.path.join(self.dir, "jobs.pkl"), "wb") as f:
            pickle.dump(jobs, f)
        self.deadline = time.monotonic() + timeout_s
        self.timeout_s = timeout_s
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), self.dir, str(r),
             str(world)], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def results(self):
        logs = []
        try:
            for p in self.procs:
                out, _ = p.communicate(timeout=max(
                    1.0, self.deadline - time.monotonic()))
                logs.append(out)
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            for p in self.procs:
                p.communicate()
            raise AssertionError(
                f"rank group timed out after {self.timeout_s} s")
        bad = [(r, p.returncode, logs[r][-3000:])
               for r, p in enumerate(self.procs) if p.returncode != 0]
        if bad:
            raise AssertionError(f"rank(s) failed: {bad}")
        out = []
        for r in range(self.world):
            with open(os.path.join(self.dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def run_group(tmp_dir, world: int, jobs, timeout_s: float = 240.0):
    """Group(...).results(): run the jobs and wait for them."""
    return Group(tmp_dir, world, jobs, timeout_s).results()


def host(ctx):
    """A MapContext of tensors as one of numpy arrays (what the ranks are
    sent: torch pickles no uint16 storage)."""
    import dataclasses
    return type(ctx)(*(getattr(ctx, f.name).numpy()
                       for f in dataclasses.fields(ctx)))


def _np(outs):
    return {k: v.cpu().numpy() for k, v in outs.items()}


# --- jobs: (rank, world, **kwargs) -> picklable result ---------------------

def job_axis(rank, world):
    import torch
    from lsdtpu_torch.runtime import shard
    from lsdtpu_torch.runtime.collectives import Axis
    mesh = shard.make_mesh_1d(device="cpu")
    ax = Axis.of(mesh, "dp")
    x = torch.tensor([1.5 * (rank + 1), -float(rank)], dtype=torch.float64)
    up, dn = ax.halo(torch.full((3,), rank + 1.0), torch.full((3,), -rank
                                                              - 1.0))
    return {"size": ax.size, "index": ax.index, "psum": ax.psum(x).numpy(),
            "pmin": ax.pmin(x).numpy(), "pmax": ax.pmax(x).numpy(),
            "bool": ax.all_gather(torch.tensor([rank % 2 == 0])).numpy(),
            "shift": ax.shift_next(x).numpy(), "up": up.numpy(),
            "dn": dn.numpy()}


def job_pod(rank, world, frames, ctxs):
    from lsdtpu_torch.runtime import distributed, shard
    out = {}
    for inner, run in (("tp", shard.run_batch_sharded),
                       ("mp", shard.run_batch_sharded_mapblocks)):
        mesh = distributed.make_pod_mesh(inner, device="cpu")
        out[inner] = {"shape": tuple(mesh.shape),
                      "names": tuple(mesh.mesh_dim_names),
                      "outs": _np(run(frames, ctxs, mesh, device="cpu"))}
        fr, cx = distributed.globalize_batch(frames, ctxs, mesh, inner,
                                             device="cpu")
        out[inner]["local"] = (tuple(fr["ranges"].shape),
                               tuple(cx.lines.shape), tuple(cx.cache.shape))
    return out


def job_shard(rank, world, frames, ctxs, cfg, kind, dp):
    from lsdtpu_torch.ops import score as osc
    from lsdtpu_torch.runtime import shard
    if kind == "tp":
        mesh = shard.make_mesh(dp=dp, device="cpu")
        run = shard.run_batch_sharded
    else:
        mesh = shard.make_mesh_mp(dp=dp, device="cpu")
        run = shard.run_batch_sharded_mapblocks
    before = osc.score_partials_batched.launches
    outs = _np(run(frames, ctxs, mesh, cfg, device="cpu"))
    outs["launches"] = osc.score_partials_batched.launches - before
    return outs


def job_temporal(rank, world, frames, ctx, warmup, n_segments):
    from lsdtpu_torch.runtime import loop, temporal
    ctx = loop.make_map_context(*ctx, dtype=frames["ranges"].dtype,
                                device="cpu")
    if n_segments % world:
        try:
            temporal.run_sequence_temporal(frames, ctx, n_segments=n_segments,
                                           device="cpu")
        except ValueError as e:
            return str(e)
        return None
    return temporal.run_sequence_temporal(
        frames, ctx, temporal.make_mesh_sp(device="cpu"), warmup=warmup,
        n_segments=n_segments, device="cpu")


def job_pipeline(rank, world, frames, ctx):
    from lsdtpu_torch.runtime import loop, pipeline
    ctx = loop.make_map_context(*ctx, dtype=frames["ranges"].dtype,
                                device="cpu")
    return _np(pipeline.run_sequence_pipelined(
        frames, ctx, pipeline.make_mesh_pp(device="cpu"), device="cpu"))


def job_lsd(rank, world, grid, dtype):
    import torch
    from lsdtpu_torch.mapprep import lsd_sharded
    from lsdtpu_torch.mapprep.stats import MapPrepStats
    from lsdtpu_torch.ops import nfa as onfa
    st = MapPrepStats()
    before = onfa.rect_counts.launches
    lines, mask, n, remapped = lsd_sharded.line_segment_detector_sharded(
        grid, dtype=getattr(torch, dtype), device="cpu", stats=st)
    return {"lines": lines.numpy(), "mask": mask.numpy(), "n": n,
            "remapped": remapped.numpy(), "nfa_calls": st.nfa_calls,
            "seeds": st.seeds, "launches": onfa.rect_counts.launches - before}


def job_prologue(rank, world, grid, blocks_per_device):
    import math
    import torch
    from lsdtpu_torch.mapprep import lsd_sharded
    out = lsd_sharded.prologue_sharded(
        grid, 0.3, 0.6, 22.5 / 180.0 * math.pi,
        blocks_per_device=blocks_per_device, dtype=torch.float64,
        device="cpu")
    return [o.numpy() if torch.is_tensor(o) else o for o in out]


def job_field(rank, world, grid, res, z, blocks_per_device):
    from lsdtpu_torch.mapprep import distance_sharded
    return distance_sharded.create_map_cache_sharded(
        grid, res, z, blocks_per_device=blocks_per_device,
        device="cpu").numpy()


def job_pool(rank, world, capacity, canvas, sessions, ticks):
    import numpy as np
    from lsdtpu_torch.runtime.serving import SessionPool, make_pool_mesh
    pool = SessionPool(capacity, canvas, dtype=np.float64, device="cpu",
                       mesh=make_pool_mesh(device="cpu"))
    for sid, args in sessions.items():
        pool.open_session(sid, *args)
    out = []
    for tick in ticks:
        for sid, scan in tick.items():
            pool.submit_scan(sid, *scan)
        out.append(pool.step())
    return out


def job_checkpoint_dcp(rank, world, path, state):
    """Every rank saves the same state (numpy fields) to one DCP
    checkpoint under the group, then loads it back."""
    from lsdtpu_torch.runtime import checkpoint, convert
    checkpoint.save_state_dcp(
        path, convert.track_state_from_numpy(**state, device="cpu"))
    return convert.track_state_to_numpy(
        checkpoint.load_state_dcp(path, device="cpu"))


JOBS = {k[4:]: v for k, v in dict(globals()).items()
        if k.startswith("job_")}


def main(tmp_dir, rank, world):
    import torch
    torch.set_num_threads(1)
    from lsdtpu_torch.runtime import distributed
    distributed.initialize(
        init_method=f"file://{os.path.join(tmp_dir, 'store')}",
        world_size=world, rank=rank, backend="gloo", device="cpu",
        timeout_s=GROUP_TIMEOUT_S)
    with open(os.path.join(tmp_dir, "jobs.pkl"), "rb") as f:
        jobs = pickle.load(f)
    results = [JOBS[name](rank, world, **kw) for name, kw in jobs]
    with open(os.path.join(tmp_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
