"""Offline pose-graph refinement of a localized trajectory."""

from lsdtpu_torch.refine.pose_graph import (refine_trajectory,
                                            refine_trajectory_distributed)

__all__ = ["refine_trajectory", "refine_trajectory_distributed"]
