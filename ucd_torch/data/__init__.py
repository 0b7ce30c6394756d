"""The port's data pipeline: dataset readers, incremental filtering and
label remapping, paired transforms and the batched loader (host-side
numpy/PIL)."""

from . import transforms
from .datasets import (
    AdeSegmentation,
    CitySegmentation,
    CityscapesSegmentationDomain,
    LearnableSynthetic,
    SyntheticSegmentation,
    VOCSegmentation,
    make_incremental_dataset,
)
from .incremental import (
    Subset,
    ade_remap_lut,
    build_remap_lut,
    city_remap_lut,
    filter_images,
    voc_remap_lut,
)
from .loader import DataLoader, split_train_val
from .native import normalize_image, pil_resize_pair, remap_labels
from .transforms import IMAGENET_MEAN, IMAGENET_STD

__all__ = [
    "transforms", "AdeSegmentation", "CitySegmentation",
    "CityscapesSegmentationDomain", "LearnableSynthetic",
    "SyntheticSegmentation", "VOCSegmentation",
    "make_incremental_dataset", "Subset", "ade_remap_lut", "build_remap_lut",
    "city_remap_lut", "filter_images", "voc_remap_lut", "DataLoader",
    "split_train_val", "normalize_image", "pil_resize_pair",
    "remap_labels", "IMAGENET_MEAN", "IMAGENET_STD",
]
