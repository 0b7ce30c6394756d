"""Streaming segmentation metrics: device-side confusion matrix.

Counterpart of ucd_tpu/engine/metrics.py. The per-batch histogram is
computed on the tensors' device inside the validate step; the host only
sees the accumulated matrix. `results_from_confusion` gives Overall / Mean
Acc, FreqW Acc, Mean IoU and the per-class breakdowns, with the "X"
placeholder for absent classes; `confusion_matrix_figure` draws the matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def confusion_matrix_update(hist: torch.Tensor, labels: torch.Tensor,
                            preds: torch.Tensor,
                            n_classes: int) -> torch.Tensor:
    """hist[i, j] += #pixels with (true == i, pred == j), over pixels whose
    label is in [0, n_classes). An exact int64 `torch.bincount` of
    label * n + pred (the JAX package's one-hot contraction is its answer
    to the TPU's slow scatter-add). Returns the new matrix."""
    lab = labels.reshape(-1).long()
    prd = preds.reshape(-1).long()
    valid = (lab >= 0) & (lab < n_classes)
    idx = lab[valid] * n_classes + prd[valid]
    counts = torch.bincount(idx, minlength=n_classes * n_classes)
    return hist + counts.view(n_classes, n_classes).to(hist.dtype)


def empty_confusion(n_classes: int, device=None) -> torch.Tensor:
    """A zero matrix on `device`: CUDA unless the caller passes one."""
    return torch.zeros((n_classes, n_classes), dtype=torch.int64,
                       device=resolve_device(device))


def results_from_confusion(hist, total_samples: int = 0) -> dict:
    EPS = 1e-6
    if isinstance(hist, torch.Tensor):
        hist = hist.detach().cpu().numpy()
    hist = np.asarray(hist, np.float64)
    gt_sum = hist.sum(axis=1)
    mask = gt_sum != 0
    diag = np.diag(hist)

    acc = diag.sum() / max(hist.sum(), EPS)
    acc_cls_c = diag / (gt_sum + EPS)
    acc_cls = np.mean(acc_cls_c[mask]) if mask.any() else 0.0
    iu = diag / (gt_sum + hist.sum(axis=0) - diag + EPS)
    mean_iu = np.mean(iu[mask]) if mask.any() else 0.0
    freq = gt_sum / max(hist.sum(), EPS)
    fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
    n = hist.shape[0]
    cls_iu = {i: (iu[i] if mask[i] else "X") for i in range(n)}
    cls_acc = {i: (acc_cls_c[i] if mask[i] else "X") for i in range(n)}
    return {
        "Total samples": total_samples,
        "Overall Acc": acc,
        "Mean Acc": acc_cls,
        "FreqW Acc": fwavacc,
        "Mean IoU": mean_iu,
        "Class IoU": cls_iu,
        "Class Acc": cls_acc,
    }


def results_to_str(results: dict) -> str:
    out = "\n"
    for k, v in results.items():
        if k not in ("Class IoU", "Class Acc", "Confusion Matrix"):
            out += f"{k}: {v:f}\n" if isinstance(v, float) else f"{k}: {v}\n"
    out += "Class IoU:\n"
    for k, v in results["Class IoU"].items():
        out += f"\tclass {k}: {v}\n"
    out += "Class Acc:\n"
    for k, v in results["Class Acc"].items():
        out += f"\tclass {k}: {v}\n"
    return out


class AverageMeter:
    """Keyed running means."""

    def __init__(self):
        self.book: dict = {}

    def reset_all(self):
        self.book.clear()

    def reset(self, key):
        if key in self.book:
            self.book[key] = [0, 0]

    def update(self, key, val):
        rec = self.book.setdefault(key, [0, 0])
        rec[0] += val
        rec[1] += 1

    def get_results(self, key):
        rec = self.book[key]
        return rec[0] / rec[1]


def confusion_matrix_figure(hist, save_path: str = None):
    """Row-normalized confusion-matrix heatmap. Returns the matplotlib
    figure and saves a PNG when `save_path` is given. matplotlib is
    imported here, under the Agg backend, so a headless host works."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(hist, torch.Tensor):
        hist = hist.detach().cpu().numpy()
    hist = np.asarray(hist, np.float64)
    cm = hist / (hist.sum(axis=1, keepdims=True) + 1e-6)
    fig, ax = plt.subplots()
    im = ax.imshow(cm, interpolation="nearest", cmap=plt.cm.viridis)
    ax.figure.colorbar(im, ax=ax)
    ax.set(title="Confusion Matrix", ylabel="True label",
           xlabel="Predicted label")
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path)
        plt.close(fig)
    return fig
