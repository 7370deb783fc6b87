"""Dataset loaders and synthetic scenes (numpy, host side)."""

from lsdtpu_torch.io.loaders import Dataset, MapParam, load_dataset

__all__ = ["Dataset", "MapParam", "load_dataset"]
