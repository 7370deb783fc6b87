"""Shared helpers of the tests that hold the PyTorch port (lsdtpu_torch)
against the JAX package (lsdtpu) on the CPU: the same synthetic scenes
(tests/test_fuzz_parity.py's generators, map artifacts from the numpy
oracle) go through both packages, and numpy arrays carry the data
between them."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lsdtpu import geometry as jgeo
from lsdtpu.mapprep import lsd as jlsd
from lsdtpu.oracle import driver as odrv
from lsdtpu.config import DEFAULT as JDEFAULT
from lsdtpu.oracle import lsd as olsd
from lsdtpu.runtime import batch as jbatch
from lsdtpu.runtime import loop as jloop
from lsdtpu.runtime import online as jonline
from lsdtpu_torch.mapprep.gaussian import gaussian_sampler
from lsdtpu_torch.mapprep.gradient import gradient_field
from lsdtpu_torch.config import DEFAULT
from lsdtpu_torch.io import synth as tsynth
from lsdtpu_torch.runtime import batch as tbatch
from lsdtpu_torch.runtime import loop as tloop
from lsdtpu_torch.runtime import online as tonline
from test_fuzz_parity import synth_dataset

CPU = torch.device("cpu")
INC = 2.0 * np.pi / 360   # the raycaster's angle step (360 rays)

# the suite runs several worker processes, each beside XLA's own thread
# pool: one intra-op thread per process keeps the CPU from oversubscribing
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def scene(seed):
    """(Dataset, oracle MapArtifacts) of test_fuzz_parity's scene."""
    ds = synth_dataset(seed)
    return ds, odrv.prepare_map(ds.map_value.copy(), ds.param.resol)


def contexts(seed, dtype=np.float64):
    """(JAX MapContext, port MapContext on the CPU) of one scene."""
    ds, art = scene(seed)
    args = (art.lines_info, art.map_cache, ds.param.resol, ds.param.ori_x,
            ds.param.ori_y)
    return (jloop.make_map_context(*args, dtype=dtype),
            tloop.make_map_context(*args, dtype=dtype, device="cpu"))


def frames(seed, dtype=np.float64):
    ds, _ = scene(seed)
    return jloop.stack_frames(ds, dtype=dtype)


def frame_inputs(fr, f):
    """(JAX, port) per-frame input tuples of frame f."""
    keys = ("ranges", "angles", "valid", "n", "odom_prev", "odom_cur")
    return (tuple(jnp.asarray(fr[k][f]) for k in keys),
            tuple(torch.as_tensor(fr[k][f]) for k in keys))


def np_(x):
    """numpy view of a JAX array or a tensor."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.array(x)


def port_candidates(jc):
    """The port's Candidates from a JAX Candidates (same values)."""
    from lsdtpu_torch.match.associate import Candidates
    return Candidates(**{k: torch.as_tensor(np_(getattr(jc, k))) for k in
                         ("ca", "sa", "sx", "sy", "mx", "my", "pose", "mask",
                          "count")})


def remap(grid):
    """The LSD's 1<->255 input remap (rows/cols >= 1), in numpy."""
    out = grid.copy()
    sub = grid[1:, 1:]
    out[1:, 1:] = np.where(sub == 1, 255, np.where(sub == 255, 0, sub))
    return out


def port_field(grid):
    """The port's f64 (mag, deg, banned, max_grad) of an occupancy grid,
    on the CPU: the LSD's blur and gradient at the default parameters."""
    gauss = gaussian_sampler(torch.from_numpy(remap(grid)).to(torch.float64))
    return gradient_field(gauss, 22.5 / 180.0 * math.pi)


@functools.lru_cache(maxsize=None)
def _jax_seed_walk(shape, max_lines, growth="wave"):
    log_nt = 5 * (math.log10(shape[0]) + math.log10(shape[1])) / 2.0
    return jax.jit(lambda m, d, b, mg: jlsd._seed_walk(
        m, d, b, mg, log_nt, 0.3, 22.5, 0.7, 1024, max_lines, growth, "xla",
        jnp.float64))


def jax_lines_on_field(field, max_lines=256, growth="wave"):
    """The reference package's seed walk (``growth`` "wave" or "fifo",
    f64) run on a given field (numpy or tensors): its valid linesInfo
    rows, (n, 10)."""
    m, d, b, mg = (np_(x) for x in field)
    ends, n = _jax_seed_walk(m.shape, max_lines, growth)(m, d, b, mg)
    n = int(n)
    assert n <= max_lines
    e = np.asarray(ends)[:n]
    return np.asarray(jgeo.lines_info_from_endpoints(
        jnp.asarray(e[:, 0]), jnp.asarray(e[:, 1]), jnp.asarray(e[:, 2]),
        jnp.asarray(e[:, 3])))


def match_lines(a, b, tol):
    """Greedy endpoint matching between two (n, 10) line sets (either
    direction of each line); the number of rows of b matched."""
    used = np.zeros(len(a), bool)
    n = 0
    for rb in b:
        d = np.minimum(np.abs(a[:, 4:8] - rb[4:8]).max(1),
                       np.abs(a[:, [6, 7, 4, 5]] - rb[4:8]).max(1))
        d[used] = np.inf
        i = int(np.argmin(d)) if len(a) else -1
        if i >= 0 and d[i] <= tol:
            used[i] = True
            n += 1
    return n


def assert_structural(got, want):
    """The reference package's wave-vs-oracle line-set tier
    (tests/test_fuzz_parity.py:139-142): count within 0.7-1.6x, 90%
    matched at 25 px, 70% at 2 px."""
    assert 0.7 * len(want) <= len(got) <= 1.6 * len(want)
    assert match_lines(got, want, 25.0) >= int(0.9 * len(want))
    assert match_lines(got, want, 2.0) >= int(0.7 * len(want))


def assert_lines_close(got, want):
    """Line sets row for row: endpoints within 1e-6 px; the derived
    linesInfo columns also within rel 1e-9 (k and b of a near-vertical
    line scale the endpoints' ulps by |k|)."""
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, 4:8], want[:, 4:8], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-6)


def localizers(seed, mode="tracking", dtype=np.float64, cfgs=None):
    """(JAX, port) localizers of one mode on the same artifacts (the
    oracle's lines; its field at z = 2 m in legacy mode)."""
    ds, art = scene(seed)
    p = ds.param
    cache = art.map_cache if mode == "tracking" else \
        olsd.create_map_cache(ds.map_value, p.resol, 2.0)
    jcfg, tcfg = cfgs or (JDEFAULT, DEFAULT)
    j = jonline.OnlineLocalizer(jcfg, mode=mode, dtype=dtype)
    t = tonline.OnlineLocalizer(tcfg, mode=mode, dtype=dtype, device="cpu")
    for loc in (j, t):
        loc.set_map_artifacts(art.lines_info, cache, p.resol, p.ori_x,
                              p.ori_y)
    return j, t


def ros_scan(frame):
    """A synthetic frame as a ROS LaserScan's ranges on the raycaster's
    uniform 360-ray grid (angle_min 0), INF where the ray hit nothing."""
    full = np.full(360, np.inf)
    full[np.rint(frame[:, 1] / INC).astype(int)] = frame[:, 0]
    return full


def grid_payload(map_value):
    """A dataset map as a ROS OccupancyGrid's int8 payload, inverting the
    reference's remap (tests/test_ros_node.py:_grid_msgs)."""
    grid = np.full(map_value.shape, 100, np.int16)
    grid[map_value == 0] = 255
    grid[map_value == 255] = 0
    return grid.reshape(-1)


# batch lanes of different map sizes and lengths: (seed, H, W, frames)
LANES = ((0, 200, 260, 10), (1, 180, 240, 10), (2, 210, 250, 7))


@functools.lru_cache(maxsize=None)
def lane_scenes(lanes=LANES):
    """(datasets, [(lines_info, map_cache)]) of synthetic scenes, one per
    (seed, H, W, frames) entry (the port's generator, which is
    test_fuzz_parity's at the default size), map artifacts from the
    numpy oracle."""
    dss = [tsynth.synth_dataset(s, F=f, H=h, W=w).dataset
           for s, h, w, f in lanes]
    arts = [odrv.prepare_map(d.map_value.copy(), d.param.resol) for d in dss]
    return dss, [(a.lines_info, a.map_cache) for a in arts]


def batch_contexts(lanes=LANES, dtype=np.float64, cfgs=None, **kw):
    """The JAX and the port stack_batch of the same scenes (port on the
    CPU): ((frames, ctxs, lens), (frames, ctxs, lens))."""
    dss, arts = lane_scenes(lanes)
    jcfg, tcfg = cfgs or (JDEFAULT, DEFAULT)
    return (jbatch.stack_batch(dss, arts, jcfg, dtype=dtype, **kw),
            tbatch.stack_batch(dss, arts, tcfg, dtype=dtype, device="cpu",
                               **kw))


def write_dataset(root, seed, suffix="", F=4, **scene_kw):
    """Write the port's synthetic scene (seed, F frames; synth_dataset's
    keyword arguments) to the directory ``root`` (a pathlib.Path) in the
    reference's text formats: mapParam, mapValue, Odom, Lidar (360 rows a
    frame, inf where a ray hit nothing), realPos (the odometry positions
    of the frames) and recored_Odom (every frame a keyframe).  Returns
    the Dataset."""
    ds = tsynth.synth_dataset(seed, F=F, **scene_kw).dataset
    p = ds.param
    (root / f"mapParam{suffix}.txt").write_text(
        f"{p.col} {p.row} {p.resol} {p.ori_x} {p.ori_y}\n")
    np.savetxt(root / f"mapValue{suffix}.txt", ds.map_value, fmt="%d")
    np.savetxt(root / "Odom.txt", ds.odom[1:], fmt="%.9f")
    rows = []
    for fr in ds.frames:
        full = np.full((360, 2), np.inf)
        full[:len(fr)] = fr
        full[len(fr):, 1] = 0.0
        rows.append(full)
    np.savetxt(root / "Lidar.txt", np.concatenate(rows), fmt="%.9f")
    np.savetxt(root / "realPos.txt", ds.odom[1:, :2], fmt="%.6f",
               delimiter="\t")
    np.savetxt(root / "recored_Odom.txt", np.arange(1, F + 1), fmt="%d")
    return ds


def solo_context(ds, art, dtype=np.float64, **kw):
    """The port's MapContext of one lane's scene alone, on the CPU."""
    p = ds.param
    return tloop.make_map_context(art[0], art[1], p.resol, p.ori_x, p.ori_y,
                                  dtype=dtype, device="cpu", **kw)
