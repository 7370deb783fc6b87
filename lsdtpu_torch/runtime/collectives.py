"""One named axis of a device mesh as process-group collectives (the
port's counterpart of the JAX package's named-axis ``psum`` / ``pmin``
/ ``pmax`` / ``ppermute`` / ``axis_index`` inside ``shard_map``).

The JAX package runs SPMD in one process over a ``jax.sharding.Mesh``;
the port runs one process per rank over a
``torch.distributed.device_mesh.DeviceMesh`` with the same dimension
names, and an ``Axis`` is one dimension of it: the process group of
this rank's row along that dimension.  ``Axis.none()`` is the unsharded
case, where every method is the identity (size 1, index 0); it is the
default of every axis argument of the port, so unsharded code calls the
same collectives and a size-1 axis passes its values through.  A caller
forks on ``axis.size > 1`` only where the identity would still cost
device work (a stack or a halo that the collective then ignores).

Every reduction is an ``all_gather`` followed by a reduction on each
rank in rank order (``psum`` adds rank 0's value, then rank 1's, ...),
so every rank of the group holds the same bits, whatever the backend's
own reduction order, and at size 1 the value passes through untouched
(a sharded runner over one rank is bitwise the unsharded one).

Gloo carries CPU tensors only (its all_gather takes no CUDA tensor):
with a gloo group, a CUDA tensor is copied to the host for the
collective and its result copied back to the device.  The copy is
explicit here, one device -> host read per collective; the kernels
still run on the card.  NCCL (one card per rank) takes the device
tensors directly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


class Axis:
    """One mesh dimension: ``size`` ranks, this rank at ``index``.

    ``Axis.of(mesh, "tp")`` is the group of ``mesh``'s "tp" dimension;
    ``Axis.none()`` the single-rank identity (one shared instance)."""

    def __init__(self, group=None):
        self.group = group
        if group is None:
            self.size, self.index, self._stage = 1, 0, False
        else:
            self.size = dist.get_world_size(group)
            self.index = dist.get_rank(group)
            self._stage = dist.get_backend(group) == "gloo"

    @classmethod
    def of(cls, mesh, dim: str) -> "Axis":
        return cls(mesh.get_group(dim))

    @classmethod
    def none(cls) -> "Axis":
        return _NONE

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, ...) stack of every rank's ``x`` (same shape and type
        on every rank), in rank order, on ``x``'s device."""
        if self.size == 1:
            return x[None]
        dev = x.device
        t = x.contiguous()
        is_bool = t.dtype == torch.bool
        if is_bool:
            t = t.to(torch.uint8)
        if self._stage and dev.type != "cpu":
            t = t.cpu()       # gloo: a stated host copy (module docstring)
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        out = torch.stack(parts).to(dev)
        return out.bool() if is_bool else out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the axis, added in rank order on every rank."""
        if self.size == 1:
            return x
        parts = self.all_gather(x)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return x
        return self.all_gather(x).amin(0)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return x
        return self.all_gather(x).amax(0)

    def shift_next(self, x: torch.Tensor) -> torch.Tensor:
        """ppermute [(i, i + 1)]: rank i's ``x`` goes to rank i + 1;
        rank 0 receives zeros (ppermute's unaddressed targets)."""
        if self.size == 1:
            return torch.zeros_like(x)
        got = self.all_gather(x)
        return got[self.index - 1] if self.index > 0 else torch.zeros_like(x)

    def halo(self, first: torch.Tensor, last: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The +-1 halo of a row-block-sharded field: (the previous
        rank's ``last``, the next rank's ``first``), zeros past either
        end (one all_gather of both)."""
        if self.size == 1:
            return torch.zeros_like(last), torch.zeros_like(first)
        got = self.all_gather(torch.stack([first, last]))
        up = got[self.index - 1, 1] if self.index > 0 \
            else torch.zeros_like(last)
        dn = got[self.index + 1, 0] if self.index + 1 < self.size \
            else torch.zeros_like(first)
        return up, dn


_NONE = Axis(None)


def gather_lanes(axis: Axis, outs: dict, n: Optional[int] = None) -> dict:
    """Every rank's lanes of a dict of (B_local, ...) tensors, in rank
    order along the lane axis ((size * B_local, ...)), cut to ``n``: one
    all_gather of the values packed into float64 (exact for the
    rollouts' outputs: floats of at most 64 bits, flags and counts)."""
    if axis.size > 1:
        B = next(iter(outs.values())).shape[0]
        flat = torch.cat([v.reshape(B, -1).to(torch.float64)
                          for v in outs.values()], 1)
        got = axis.all_gather(flat).flatten(0, 1)
        full, i = {}, 0
        for k, v in outs.items():
            w = v[0].numel()
            full[k] = got[:, i:i + w].reshape((-1,) + tuple(v.shape[1:])
                                              ).to(v.dtype)
            i += w
        outs = full
    return outs if n is None else {k: v[:n] for k, v in outs.items()}


def rank_slice(n: int, axis: Axis) -> slice:
    """This rank's block of ``n`` items split evenly over the axis (n a
    multiple of its size)."""
    per = n // axis.size
    return slice(axis.index * per, (axis.index + 1) * per)
