"""Inference npz loading and standalone batch prediction.

Counterpart of ucd_tpu/engine/export.py. `load_inference` reads the same
self-describing `ucd_tpu.inference.v1` npz the JAX package exports, so one
file serves both packages: bf16 leaves are stored as uint16 bit patterns
and decode without ml_dtypes. `export_inference` packs a step checkpoint
of the port into that format (the class list read off the checkpoint's
`cls_*` heads), and `save_inference` writes it from a live port model.

`predict_paths` runs the Predictor over image files, padding each image up
to a spatial bucket and batching same-bucket images per device call.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.convert import flax_to_state_dict, state_dict_to_flax
from ..models.segmentation import IncrementalSegmentationModel

_META_KEY = "__ucd_tpu_meta__"
FORMAT = "ucd_tpu.inference.v1"


def _bf16_from_bits(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
        torch.bfloat16)


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """f32 -> bf16 (round to nearest even, as ml_dtypes) as uint16 bits."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def load_inference(path: str, device=None):
    """Inference npz -> (model in eval mode on `device`, meta). Needs no
    Config. The model computes in the npz's dtype (bf16 or f32)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    if _META_KEY not in flat:
        raise ValueError(
            f"{path!r} is not a ucd_tpu inference export (missing meta "
            f"header); produce one with `ucd_tpu export`")
    meta = json.loads(bytes(flat.pop(_META_KEY).tobytes()).decode())
    bf16_keys = set(meta.get("bf16_keys", ()))
    tensors = {k: _bf16_from_bits(v) if k in bf16_keys else torch.from_numpy(v)
               for k, v in flat.items()}
    dtype = torch.bfloat16 if meta["dtype"] == "bfloat16" else torch.float32
    model = IncrementalSegmentationModel(
        classes=tuple(meta["classes"]),
        backbone=meta["backbone"],
        output_stride=meta["output_stride"],
        head_channels=meta["head_channels"],
        pooling_size=meta["pooling"],
        dtype=dtype,
        param_dtype=dtype,  # serving keeps the npz's weights as they are
    )
    model.load_state_dict(flax_to_state_dict(tensors), strict=True)
    model.to(device=dev, memory_format=torch.channels_last).eval()
    return model, meta


def _write_npz(sd, out_path: str, export_dtype: str, dataset: str,
               **arch) -> dict:
    """A state_dict -> inference npz: float params cast to `export_dtype`
    (bf16 as uint16 bit patterns), BN running statistics kept f32, the
    architecture `arch` in an embedded JSON header."""
    flat, bf16_keys = {}, []
    for k, v in state_dict_to_flax(sd).items():
        if k.startswith("params/"):
            if export_dtype == "bfloat16":
                v = _bf16_bits(v)
                bf16_keys.append(k)
        else:
            v = np.asarray(v, np.float32)
        flat[k] = v
    meta = {"bf16_keys": bf16_keys, "format": FORMAT, **arch,
            "stem_s2d": False, "dataset": dataset, "dtype": export_dtype}
    flat[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    if not out_path.endswith(".npz"):
        out_path += ".npz"  # np.savez appends it silently; keep paths honest
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, **flat)
    return dict(meta, path=out_path)


def save_inference(model: IncrementalSegmentationModel, out_path: str,
                   dataset: str = "voc",
                   export_dtype: str = "bfloat16") -> dict:
    """Port model -> inference npz in the JAX package's format. Returns the
    meta dict (with the written path under "path")."""
    return _write_npz(
        model.state_dict(), out_path, export_dtype,
        backbone=model.backbone, output_stride=model.output_stride,
        classes=list(model.classes), head_channels=model.head_channels,
        pooling=model.pooling_size, dataset=dataset)


def _classes_from_params(params) -> Tuple[list, Optional[int]]:
    """(per-step class counts, head channels) read off the `cls_{i}`
    classifier weights: the checkpoint, not the flags, says which heads the
    model has."""
    steps = sorted({int(k.split(".")[0].split("_", 1)[1]) for k in params
                    if k.startswith("cls_")})
    if steps != list(range(len(steps))):
        raise ValueError(f"non-contiguous classifier heads in checkpoint: "
                         f"cls_{steps}")
    classes, head_ch = [], None
    for i in steps:
        w = params[f"cls_{i}.weight"]  # (classes, head channels, 1, 1)
        classes.append(int(w.shape[0]))
        head_ch = int(w.shape[1])
    return classes, head_ch


def export_inference(ckpt_path: str, out_path: str, cfg,
                     export_dtype: str = "bfloat16") -> dict:
    """Step checkpoint of the port -> standalone inference npz (the JAX
    package's format: one file serves both packages). Returns the meta dict
    (with the written path under "path").

    Float params are cast to `export_dtype`; BN statistics stay f32. The
    per-step class list and the head width come from the checkpoint's
    classifier weights; `cfg` supplies what the weights cannot express
    (backbone name, output stride, pooling, palette)."""
    from .checkpoint import check_schema, load_checkpoint, state_dict_of

    raw = load_checkpoint(ckpt_path)
    if raw is None:
        raise FileNotFoundError(f"no checkpoint at {ckpt_path!r}")
    check_schema(raw, ckpt_path)
    ms = raw["model_state"]
    classes, head_channels = _classes_from_params(ms["params"])
    if not classes:
        raise ValueError(f"checkpoint at {ckpt_path!r} has no cls_* heads")
    if list(cfg.classes_per_step) != classes:
        print(f"[export] note: checkpoint has per-step classes {classes} "
              f"(flags implied {list(cfg.classes_per_step)}); "
              "using the checkpoint's")
    return _write_npz(
        state_dict_of(ms), out_path, export_dtype, backbone=cfg.backbone,
        output_stride=cfg.output_stride, classes=classes,
        head_channels=head_channels, pooling=cfg.pooling,
        dataset=cfg.dataset)


def _bucket_hw(h: int, w: int, multiple: int) -> Tuple[int, int]:
    return -(-h // multiple) * multiple, -(-w // multiple) * multiple


class _PendingFetch:
    """A chunk's device->host copy, enqueued on the stream right behind the
    chunk's kernels into pinned memory. `np.asarray` waits for it: that is
    the fetch, and device errors of the chunk surface there. Copying at
    dispatch keeps a later chunk's kernels from delaying this one's
    result."""

    def __init__(self, dev_preds: torch.Tensor):
        self.host = torch.empty(dev_preds.shape, dtype=dev_preds.dtype,
                                pin_memory=True)
        self.host.copy_(dev_preds, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def __array__(self, dtype=None, copy=None):
        self.event.synchronize()
        return self.host.numpy()


def dispatch_padded_chunk(predictor, key: Tuple[int, int],
                          imgs: Sequence[tuple], batch_size: int,
                          full_seen: set):
    """Enqueue one batched device call over `imgs` = [(img_u8 HWC, h, w),
    ...], all padded into the (hb, wb) spatial bucket `key`, WITHOUT
    waiting for the result, so a caller (the serving MicroBatcher) can
    overlap this chunk's upload, compute and download with collecting and
    dispatching the next one.

    A partial chunk pads the BATCH dim back up to `batch_size` when a full
    chunk already ran for this bucket (one batch shape per bucket keeps the
    device work and its kernel choices the same); a bucket that has never
    seen a full chunk runs at its natural size. Full chunks are recorded in
    `full_seen`. Returns (pending preds, padded row count)."""
    hb, wb = key
    n = len(imgs)
    run_n = batch_size if (n == batch_size or key in full_seen) else n
    arr = np.zeros((run_n, hb, wb, 3), np.uint8)
    for i, (img, h, w) in enumerate(imgs):
        arr[i, :h, :w] = img
    dev_preds = predictor.predict_labels(arr)
    if isinstance(dev_preds, torch.Tensor) and dev_preds.is_cuda:
        dev_preds = _PendingFetch(dev_preds)
    if n == batch_size:
        full_seen.add(key)
    return dev_preds, run_n - n


def complete_padded_chunk(dev_preds, imgs: Sequence[tuple]) -> list:
    """Fetch a dispatched chunk and crop each prediction back to its native
    size. Device errors from the asynchronous call materialize here."""
    preds = np.asarray(dev_preds)
    return [preds[i, :h, :w].astype(np.uint8)
            for i, (_, h, w) in enumerate(imgs)]


def run_padded_chunk(predictor, key: Tuple[int, int], imgs: Sequence[tuple],
                     batch_size: int, full_seen: set) -> Tuple[list, int]:
    """dispatch + complete in one synchronous call (the predict_paths path;
    the MicroBatcher uses the split pair to pipeline chunks). Returns
    (per-image (h, w) uint8 class maps cropped to native size, padded row
    count)."""
    dev_preds, padded = dispatch_padded_chunk(predictor, key, imgs,
                                              batch_size, full_seen)
    return complete_padded_chunk(dev_preds, imgs), padded


def predict_paths(model, image_paths: Sequence[str], out_dir: str,
                  dataset: str = "voc", *, bucket: int = 128,
                  batch_size: int = 8, fusion_mode: str = "mean",
                  scales: Sequence[float] = (1.0,), flip: bool = False,
                  save_color: bool = True, save_ids: bool = False,
                  fused: bool = True, io_workers: int = 8,
                  device=None) -> list:
    """Predict class maps for arbitrary image files; returns written paths.

    Images ship as raw uint8 (the device normalizes) padded to `bucket`
    multiples; predictions are cropped back to the native size.
    `<stem>_color.png` is the dataset-palette rendering, `<stem>_ids.png`
    the raw class-id map. Same-bucket images are batched up to
    `batch_size` per device call. Decodes run `io_workers` ahead through a
    thread pool (a bounded window) and PNG encodes go to the same pool."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from ..utils.viz import color_map, palette_png
    from .predictor import Predictor

    predictor = Predictor(model, fusion_mode=fusion_mode, flip=flip,
                          scales=scales, fused=fused, device=device)
    cmap = color_map(dataset)
    os.makedirs(out_dir, exist_ok=True)
    batch_size = max(int(batch_size), 1)
    io_workers = max(int(io_workers), 1)

    def decode(p):
        return np.asarray(Image.open(p).convert("RGB"), np.uint8)

    def write_one(preds, stem):
        outs = []
        if save_ids:
            out = os.path.join(out_dir, f"{stem}_ids.png")
            Image.fromarray(preds).save(out, compress_level=1)
            outs.append(out)
        if save_color:
            out = os.path.join(out_dir, f"{stem}_color.png")
            palette_png(preds, cmap).save(out, compress_level=1)
            outs.append(out)
        return outs

    pool = ThreadPoolExecutor(io_workers, thread_name_prefix="ucd-predict-io")
    pending: dict = {}      # (hb, wb) -> [((img u8 HWC, h, w), stem), ...]
    full_seen: set = set()  # buckets that already ran a full-size chunk
    write_futs: list = []   # submission order == flush order: deterministic

    def flush(key):
        group = pending.pop(key, [])
        if not group:
            return
        preds, _ = run_padded_chunk(predictor, key, [g[0] for g in group],
                                    batch_size, full_seen)
        for p, (_, stem) in zip(preds, group):
            write_futs.append(pool.submit(write_one, p, stem))

    used_stems: dict = {}
    try:
        window = max(2 * batch_size, 2 * io_workers)
        dq: deque = deque()
        path_iter = iter(image_paths)
        exhausted = False
        while True:
            while not exhausted and len(dq) < window:
                p = next(path_iter, None)
                if p is None:
                    exhausted = True
                    break
                dq.append((p, pool.submit(decode, p)))
            if not dq:
                break
            p, fut = dq.popleft()
            img = fut.result()
            h, w = img.shape[:2]
            key = _bucket_hw(h, w, bucket)
            # stems are assigned in INPUT order, so which of a.png / a.jpg
            # gets the "_1" suffix does not depend on batching
            stem = os.path.splitext(os.path.basename(p))[0]
            k = used_stems.get(stem, 0)
            used_stems[stem] = k + 1
            if k:
                stem = f"{stem}_{k}"
            pending.setdefault(key, []).append(((img, h, w), stem))
            if len(pending[key]) == batch_size:
                flush(key)
        for key in list(pending):
            flush(key)
        return [out for fut in write_futs for out in fut.result()]
    finally:
        pool.shutdown(wait=True)


def collect_images(images: str) -> list:
    """A file, or every image file directly inside a directory."""
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
    if os.path.isfile(images):
        return [images]
    if os.path.isdir(images):
        files = sorted(
            os.path.join(images, f) for f in os.listdir(images)
            if f.lower().endswith(exts))
        if not files:
            raise FileNotFoundError(f"no image files in {images!r}")
        return files
    raise FileNotFoundError(images)
