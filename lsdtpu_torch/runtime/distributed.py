"""Process groups and pod meshes (counterpart of
lsdtpu/runtime/distributed.py).

The reference package runs one JAX process per host over a global device
mesh.  The port runs one process per rank (one card each, or several
ranks sharing one card) under ``torch.distributed``:

  * ``initialize`` starts the default process group from torchrun's
    environment (MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK /
    LOCAL_RANK) where the reference reads JAX_COORDINATOR /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID, and does nothing at world size 1;
  * ``make_pod_mesh`` lays dp over hosts and tp (or mp) over each host's
    local ranks, so the per-frame collectives stay inside a host;
  * ``globalize_batch`` is this rank's shard of a host-replicated batch on
    its device (what the sharded runners of runtime/shard.py take).

The backend is an explicit choice: NCCL where every rank has a card of
its own, gloo on the CPU and where several ranks share one card (NCCL
refuses two ranks on one GPU).  ``default_backend`` makes that choice
when none is given, and the group prints the one it took.  Every group
has a timeout, so a collective that one rank never joins fails instead
of hanging.
"""

from __future__ import annotations

import datetime
import os
import socket
import sys
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from lsdtpu_torch import resolve_device

DP_AXIS = "dp"
TP_AXIS = "tp"
MP_AXIS = "mp"
TIMEOUT_S = 120.0


def default_backend(device, local_world: int) -> str:
    """"nccl" when the ranks run on cards and every one of the host's
    ``local_world`` ranks has a card of its own, else "gloo"."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def _announce(backend: str, world: int, rank: int) -> None:
    print(f"lsdtpu_torch.distributed: backend {backend}, world size "
          f"{world}, rank {rank}", file=sys.stderr, flush=True)


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None, device="cuda",
               timeout_s: float = TIMEOUT_S) -> Optional[str]:
    """Start the default process group; returns the backend, or None at
    world size 1 (nothing to start).

    world_size and rank default to WORLD_SIZE and RANK; init_method to
    "env://" (MASTER_ADDR, MASTER_PORT).  backend None takes
    ``default_backend(device, LOCAL_WORLD_SIZE)``.  On the card the rank
    takes card LOCAL_RANK (modulo the cards present, so ranks may share
    one)."""
    n = world_size if world_size is not None else \
        int(os.environ.get("WORLD_SIZE", "1"))
    if n <= 1:
        return None
    if rank is None:
        env = os.environ.get("RANK")
        if env is None:
            # rank 0 on every process would give the store duplicate
            # ranks and hang the job with no hint why
            raise ValueError(f"world_size={n} but no rank: pass rank= or "
                             "set RANK per process")
        rank = int(env)
    dev = resolve_device(device)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(n)))
    backend = backend or default_backend(dev, local)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", str(rank)))
                              % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=n,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    _announce(backend, n, rank)
    return backend


def ensure_group(device="cuda", timeout_s: float = TIMEOUT_S) -> None:
    """The default group, started as a one-rank group (an in-process
    store) where none was initialized: a mesh over one rank."""
    if dist.is_initialized():
        return
    backend = default_backend(device, 1)
    dist.init_process_group(backend, store=dist.HashStore(), world_size=1,
                            rank=0,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _announce(backend, 1, 0)


def device_mesh(device, shape, names, ranks=None):
    """A DeviceMesh of ``shape`` over the default group's ranks (row-major
    ``ranks`` order by default) with dimension ``names``."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    ensure_group(dev)
    n = int(np.prod(shape))
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the "
                         f"process group has {world}")
    r = torch.arange(n) if ranks is None else torch.as_tensor(ranks)
    return DeviceMesh(dev.type, r.reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_pod_mesh(inner: str = TP_AXIS, device="cuda"):
    """(dp, inner) mesh: dp over hosts, inner (TP_AXIS or MP_AXIS) over
    each host's ranks, the rows grouped by host explicitly (rank order
    need not be host-major).  Raises when the hosts hold uneven
    numbers of ranks."""
    if inner not in (TP_AXIS, MP_AXIS):
        raise ValueError(f"inner must be {TP_AXIS!r} or {MP_AXIS!r}, got "
                         f"{inner!r}")
    ensure_group(device)
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    by_host: dict = {}
    for r, h in enumerate(hosts):
        by_host.setdefault(h, []).append(r)
    rows = [by_host[h] for h in sorted(by_host, key=lambda h: by_host[h][0])]
    if len({len(r) for r in rows}) != 1:
        raise ValueError("ranks are not evenly spread over hosts: "
                         + str({h: len(r) for h, r in by_host.items()}))
    return device_mesh(device, (len(rows), len(rows[0])), (DP_AXIS, inner),
                       ranks=rows)


def globalize_batch(frames, ctxs, mesh, inner: str = TP_AXIS,
                    device="cuda"):
    """This rank's shard of a host-replicated batch, on ``device``:
    (frames (B/dp, F, ...) tensors, MapContext), padded to the mesh as
    runtime/shard.py's runners pad it.  The runners take the replicated
    batch and call this themselves."""
    from lsdtpu_torch.runtime import shard
    kind = "tp" if inner == TP_AXIS else "mp"
    fr, cx, _B = shard.local_batch(frames, ctxs, mesh, kind, device)
    return fr, cx
