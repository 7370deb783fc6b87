"""Dataset loaders, reference-format dumps, a prefetching feeder and
synthetic scenes (numpy, host side)."""

from lsdtpu_torch.io.loaders import (Dataset, MapParam, load_dataset,
                                     load_lidar_frames, load_lines_info,
                                     load_map_param, load_map_value,
                                     load_odom, load_real_pos,
                                     load_recorded_odom)

__all__ = ["Dataset", "MapParam", "load_dataset", "load_lidar_frames",
           "load_lines_info", "load_map_param", "load_map_value",
           "load_odom", "load_real_pos", "load_recorded_odom"]
