"""Shared helpers of the tests that hold the PyTorch port (lsdtpu_torch)
against the JAX package (lsdtpu) on the CPU: the same synthetic scenes
(tests/test_fuzz_parity.py's generators, map artifacts from the numpy
oracle) go through both packages, and numpy arrays carry the data
between them."""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from lsdtpu.oracle import driver as odrv
from lsdtpu.runtime import loop as jloop
from lsdtpu_torch.runtime import loop as tloop
from test_fuzz_parity import synth_dataset

CPU = torch.device("cpu")

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
