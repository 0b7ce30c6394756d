"""ImageNet normalization constants (a copy of the values in
ucd_tpu/data/transforms.py; the paired image/label transforms come with the
experiment slice)."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
