"""Inputs and weights made from a run's seed, on the device, in a few large
calls: uint8 images with spatial structure, label maps of the step's
classes, and the seeded, BatchNorm-calibrated weights that both the
program and the reference are handed.

The same seed gives the same tensors; every seed gives the same sizes.
Seeds are folded to 63 bits, so any whole number a driver passes works.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from ..reference import model as RM


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on `device` for one named use of the run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(h[:8], "little") >> 1)
    return g


def images(n: int, h: int, w: int, g: torch.Generator, device) -> torch.Tensor:
    """(n, h, w, 3) uint8: smooth colour fields plus noise."""
    low = torch.rand(n, 3, 6, 8, generator=g, device=device) * 255
    img = F.interpolate(low, size=(h, w), mode="bilinear",
                        align_corners=False)
    img += torch.randn(n, 3, h, w, generator=g, device=device) * 12
    return img.clamp_(0, 255).round_().to(torch.uint8).permute(
        0, 2, 3, 1).contiguous()


def labels(n: int, h: int, w: int, new_classes: Sequence[int], per_image: int,
           band: int, g: torch.Generator, device) -> torch.Tensor:
    """(n, h, w) uint8 label maps: smooth blobs of background (0) and of
    `per_image` classes drawn from `new_classes` for each image, with an
    ignore band (255) `band` pixels wide along every edge between two
    regions, as annotated segmentation data has."""
    k = per_image + 1
    score = torch.randn(n, k, 8, 8, generator=g, device=device)
    score[:, 0] += 0.5  # background the largest region
    score = F.interpolate(score, size=(h, w), mode="bilinear",
                          align_corners=False)
    pick = torch.randint(0, len(new_classes), (n, per_image), generator=g,
                         device=device)
    ids = torch.cat([torch.zeros(n, 1, dtype=torch.long, device=device),
                     torch.as_tensor(list(new_classes), device=device)[pick]],
                    dim=1)
    lab = ids.gather(1, score.argmax(dim=1).view(n, -1)).view(n, 1, h, w)
    lab = lab.float()
    hi = F.max_pool2d(lab, 2 * band + 1, 1, band)
    lo = -F.max_pool2d(-lab, 2 * band + 1, 1, band)
    lab = torch.where(hi != lo, 255.0, lab)
    return lab[:, 0].to(torch.uint8).contiguous()


def model_weights(arch: dict, seed: int, device, calibration: Sequence[int],
                  dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Seeded weights of `arch` (float32, or float64 for the CPU tests),
    its BatchNorm statistics and classifier scales calibrated on one seeded
    batch of `calibration` = (n, h, w) images (reference/model.py
    `calibrate`)."""
    sd = RM.init_state(arch, generator(seed, "weights", device), device,
                       dtype)
    n, h, w = calibration
    cal = images(n, h, w, generator(seed, "calibration", device), device)
    RM.calibrate(sd, arch, cal)
    return sd
