"""Rollout runtime: the per-frame step, the sequence loop, and state
conversion from the reference package."""

from lsdtpu_torch.runtime.loop import (MapContext, TrackState, init_state,
                                       localization_step, make_map_context,
                                       run_sequence, stack_frames)

__all__ = ["MapContext", "TrackState", "init_state", "localization_step",
           "make_map_context", "run_sequence", "stack_frames"]
