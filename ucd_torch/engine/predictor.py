"""Batched inference with optional test-time augmentation.

Counterpart of ucd_tpu/engine/predictor.py. Fusion modes over TTA views:

  mean   — average class probabilities over the views
  max    — elementwise max of probabilities over the views
  voting — majority vote of per-view argmax predictions

Images come in the JAX layout, (B, H, W, 3) uint8 RGB (or normalized
float); they are viewed as NCHW channels_last on the device without a copy.
Both entry points run under `torch.inference_mode()` inside themselves:
the serving MicroBatcher calls them from its own thread, and inference
mode is thread-local.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.segmentation import normalize_uint8, resize_bilinear
from ..ops import fused_eval as FE


class Predictor:
    def __init__(self, model, fusion_mode: str = "mean", flip: bool = False,
                 scales: Sequence[float] = (1.0,), fused: bool = True,
                 device=None):
        if fusion_mode not in ("mean", "voting", "max"):
            raise ValueError(f"unknown fusion mode {fusion_mode!r}")
        self.device = resolve_device(device)
        # the weights go to the device once, here (a no-op for a model that
        # load_inference already placed there)
        self.model = model.to(self.device).eval()
        self.fusion_mode = fusion_mode
        self.flip = flip
        # normalize a bare float/int to a 1-view pyramid
        self.scales = ((float(scales),) if isinstance(scales, (int, float))
                       else tuple(float(s) for s in scales))
        self.fused = fused

    def _to_device(self, images) -> torch.Tensor:
        """(B, H, W, 3) array or tensor -> NCHW view on the device. A host
        batch is staged in pinned memory so the upload is stream-ordered
        and does not wait for the previous batch's kernels."""
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images))
        if self.device.type == "cuda" and images.device.type == "cpu":
            images = images.pin_memory().to(self.device, non_blocking=True)
        return images.to(self.device).permute(0, 3, 1, 2)

    def _forward(self, images: torch.Tensor):
        if images.dtype == torch.uint8:
            # normalize BEFORE the multi-scale pyramid: resizing raw RGB
            # would hand the model float views that skip its uint8 path
            images = normalize_uint8(images)
        h, w = images.shape[2], images.shape[3]
        view_logits = []
        for s in self.scales:
            sh, sw = int(round(h * s)), int(round(w * s))
            x = images if s == 1.0 else resize_bilinear(images, (sh, sw))
            views = [x, x.flip(3)] if self.flip else [x]
            for i, v in enumerate(views):
                logits = resize_bilinear(self.model.forward_sem(v),
                                         v.shape[2:])
                if i == 1:
                    logits = logits.flip(3)
                if logits.shape[2] != h:
                    logits = resize_bilinear(logits, (h, w))
                view_logits.append(logits)

        probs = [F.softmax(l, dim=1) for l in view_logits]
        if self.fusion_mode == "mean":
            fused = sum(probs) / len(probs)
        elif self.fusion_mode == "max":
            fused = probs[0]
            for p in probs[1:]:
                fused = torch.maximum(fused, p)
        else:  # voting: majority over per-view argmax
            n_classes = view_logits[0].shape[1]
            votes = sum(F.one_hot(p.argmax(dim=1), n_classes).float()
                        for p in probs)
            return votes.argmax(dim=-1), votes / len(probs)
        return fused.argmax(dim=1), fused.permute(0, 2, 3, 1)

    @torch.inference_mode()
    def predict_labels(self, images) -> torch.Tensor:
        """(B, H, W) uint8 class ids, left on the device (the caller's
        fetch is the only sync). A single view takes the fused
        upsample+argmax kernel on the model's low-res logits, so the
        full-res logits never exist; TTA configurations take the full
        fusion. Ids are cast to uint8 on the device: 4x less
        device->host traffic than int32 (every dataset has <= 256
        classes)."""
        x = self._to_device(images)
        if self.scales == (1.0,) and not self.flip:
            H, W = x.shape[2], x.shape[3]
            sem = self.model.forward_sem(x)
            sem_nhwc = sem.permute(0, 2, 3, 1)
            if self.fused and FE.supported(sem_nhwc.shape, (H, W)):
                preds = FE.fused_argmax(sem_nhwc.contiguous(), (H, W))
            else:
                preds = resize_bilinear(sem, (H, W)).argmax(dim=1)
        else:
            preds, _ = self._forward(x)
        return preds.to(torch.uint8)

    @torch.inference_mode()
    def __call__(self, images):
        """images: (B, H, W, 3) uint8 or normalized float. Returns
        (preds (B, H, W), fused (B, H, W, C)) on the device."""
        return self._forward(self._to_device(images))
