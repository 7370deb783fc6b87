"""Rollout runtime: the per-frame step, the sequence loop, batched
rollouts over a lane axis, the multi-robot serving pool, and state
conversion from the reference package."""

from lsdtpu_torch.runtime.batch import (run_batch, stack_batch,
                                        stack_concat)
from lsdtpu_torch.runtime.loop import (MapContext, TrackState, batched_cfg,
                                       init_state, localization_step,
                                       make_map_context, run_sequence,
                                       stack_frames)
from lsdtpu_torch.runtime.serving import SessionPool

__all__ = ["MapContext", "SessionPool", "TrackState", "batched_cfg",
           "init_state", "localization_step", "make_map_context",
           "run_batch", "run_sequence", "stack_batch", "stack_concat",
           "stack_frames"]
