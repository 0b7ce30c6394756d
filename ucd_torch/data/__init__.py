"""Host-side data constants of the port (the loaders come with the experiment
slice)."""

from .transforms import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD"]
