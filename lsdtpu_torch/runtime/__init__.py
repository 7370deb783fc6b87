"""Rollout runtime: the per-frame step, the sequence loop, batched
rollouts over a lane axis, the multi-robot serving pool, and state
conversion from the reference package.

The names below are loaded on first use, so that importing one module
of the package (map prep imports runtime.collectives) does not import
the others, which import map prep."""

import importlib

_EXPORTS = {"run_batch": "batch", "stack_batch": "batch",
            "stack_concat": "batch", "MapContext": "loop",
            "TrackState": "loop", "batched_cfg": "loop", "init_state": "loop",
            "localization_step": "loop", "make_map_context": "loop",
            "run_sequence": "loop", "stack_frames": "loop",
            "SessionPool": "serving"}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
