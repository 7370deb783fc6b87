"""Counters of one map-prep run: how often the host loop waited on the
device and what it launched.  The caller creates one and passes it
down; chip_smoke.py reports them per map, OnlineLocalizer.set_map keeps
the last map's, and map prep sets them on the tracer's ``mapprep.lsd``
span."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lsdtpu_torch.runtime import trace


@dataclasses.dataclass
class MapPrepStats:
    seeds: int = 0       # seed-walk iterations (seed pixels visited)
    waves: int = 0       # region-growth waves (wave growth)
    wave_calls: int = 0  # wave growth calls at one rank (grow_wave launches
    #                      on the card; each one device read)
    fifo_calls: int = 0  # FIFO growth calls (grow_fifo launches on the card)
    pops: int = 0        # pixels popped from the FIFO queues, all passes
    passes: int = 0      # FIFO queue passes (the first and every re-sweep)
    reducer_passes: int = 0  # FIFO radius-reducer passes (launches)
    nfa_calls: int = 0   # rect_counts calls (kernel launches on the card)
    nfa_rects: int = 0   # rectangles counted over all calls
    syncs: int = 0       # device -> host reads the loop waited on

    def to_host(self, site: str, t: torch.Tensor) -> np.ndarray:
        """``t`` as a numpy array: one device -> host read, counted here
        and as the tracer's ``host_reads.mapprep.<site>``."""
        self.syncs += 1
        return trace.host_read("mapprep." + site, t)
