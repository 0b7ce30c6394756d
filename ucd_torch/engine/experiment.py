"""Experiment orchestration: dataset assembly, the epoch loop, validation,
checkpointing and the final all-classes test.

Counterpart of ucd_tpu/engine/experiment.py, the reference's run.py flow:
datasets -> model + frozen donor (restored from the previous step's
checkpoint) -> optimizer and schedule -> epoch loop (train, validate,
save) -> final test on every class seen so far.

The port runs one process on one device (CUDA unless the caller passes
`device="cpu"`; it never moves to the CPU on its own). What the JAX class
does for a mesh (sharding, per-host batch assembly) and for XLA (the
compile cache, K-step bundles) has no counterpart here: `steps_per_call >
1` raises, naming ROADMAP A8, and multi-process runs wait for A6.
`profile_dir` traces the first epoch with torch.profiler.

The train loop keeps the step's metrics on the device and fetches them
once per `print_interval` and once at the end of the epoch: no per-step
host sync.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import tasks as task_registry
from ..config import Config
from ..data import DataLoader, make_incremental_dataset, split_train_val
from ..data.transforms import train_transform, val_transform
from ..device import resolve_device
from ..models import make_model
from ..utils.viz import compose_sample_png
from . import checkpoint as ckpt_lib
from .logger import Logger
from .metrics import empty_confusion, results_from_confusion, results_to_str
from .state import build_train_state
from .train import make_eval_step, make_train_step


def get_datasets(cfg: Config, base_train=None, base_val=None):
    """Train/val/test datasets: train on the new classes (masked); val =
    the disk val split by default, or an 80/20 random split of train under
    `cross_val`; test on all seen classes. Returns (train, val, test,
    number of classes seen)."""
    labels, labels_old, path_base = task_registry.get_task_labels(
        cfg.dataset, cfg.task, cfg.step)
    labels_cum = labels_old + labels
    if cfg.overlap:
        path_base += "-ov"
    idx_dir = None
    if base_train is None:
        os.makedirs(path_base, exist_ok=True)
        idx_dir = path_base
    train_dst = make_incremental_dataset(
        cfg.dataset, cfg.data_root, train=True,
        transform=train_transform(cfg.crop_size,
                                  device_normalize=cfg.device_normalize),
        labels=labels, labels_old=labels_old,
        idxs_path=(f"{idx_dir}/train-{cfg.step}.npy" if idx_dir else None),
        masking=cfg.masking, overlap=cfg.overlap, base=base_train)

    if cfg.cross_val:
        train_dst, val_dst = split_train_val(train_dst, 0.2, cfg.random_seed)
    else:
        val_dst = make_incremental_dataset(
            cfg.dataset, cfg.data_root, train=False,
            transform=val_transform(cfg.crop_size if cfg.crop_val else None,
                                    device_normalize=cfg.device_normalize),
            labels=labels, labels_old=labels_old,
            idxs_path=(f"{idx_dir}/val-{cfg.step}.npy" if idx_dir else None),
            masking=cfg.masking, overlap=True,
            base=base_val if base_val is not None else base_train)

    # --val_on_trainset: test on the train split
    image_set = "train" if cfg.val_on_trainset else "val"
    test_base = base_train if cfg.val_on_trainset else (
        base_val if base_val is not None else base_train)
    test_dst = make_incremental_dataset(
        cfg.dataset, cfg.data_root, train=cfg.val_on_trainset,
        transform=val_transform(cfg.crop_size if cfg.crop_val else None,
                                device_normalize=cfg.device_normalize),
        labels=labels_cum, labels_old=None,
        idxs_path=(f"{idx_dir}/test_on_{image_set}-{cfg.step}.npy"
                   if idx_dir else None),
        masking=True, overlap=True, base=test_base)

    return train_dst, val_dst, test_dst, len(labels_cum) + 1


def pad_to_bucket(batch: dict, multiple: int) -> dict:
    """Pad images (zeros) and labels (ignore = 255) up to the next spatial
    bucket: H and W each rounded up to a multiple of `multiple`, so
    full-size eval sees a few batch shapes rather than one per image size.
    Padded label pixels are 255 and count in no loss and no confusion
    entry; outputs near the padded border can shift within the receptive
    field of the convolutions and the ASPP pooling."""
    h, w = batch["label"].shape[1:3]
    hb = -(-h // multiple) * multiple
    wb = -(-w // multiple) * multiple
    if (hb, wb) == (h, w):
        return batch
    return {
        "image": np.pad(batch["image"],
                        ((0, 0), (0, hb - h), (0, wb - w), (0, 0))),
        "label": np.pad(batch["label"], ((0, 0), (0, hb - h), (0, wb - w)),
                        constant_values=255),
    }


def pad_batch(batch: dict, rows: int) -> dict:
    """Pad the batch dimension up to `rows` with ignore-labelled zero
    images (excluded from the confusion matrix and every loss numerator):
    the last short batch of an eval stream keeps the full batch shape."""
    rem = rows - batch["label"].shape[0]
    if rem <= 0:
        return batch
    return {
        "image": np.concatenate(
            [batch["image"], np.zeros((rem,) + batch["image"].shape[1:],
                                      batch["image"].dtype)]),
        "label": np.concatenate(
            [batch["label"], np.full((rem,) + batch["label"].shape[1:], 255,
                                     batch["label"].dtype)]),
    }


def _fetch(metrics: list) -> list:
    """Device metric dicts -> host dicts of floats, with one device->host
    copy for all of them."""
    if not metrics:
        return []
    keys = [k for k, v in metrics[0].items() if isinstance(v, torch.Tensor)]
    host = torch.stack([torch.stack([m[k].to(torch.float64) for k in keys])
                        for m in metrics]).cpu().tolist()
    return [{**{k: float(v) for k, v in m.items()
                if not isinstance(v, torch.Tensor)},
             **dict(zip(keys, row))} for m, row in zip(metrics, host)]


class Experiment:
    def __init__(self, cfg: Config, base_train=None, base_val=None,
                 logger: Optional[Logger] = None, device=None):
        cfg.validate()
        if cfg.steps_per_call > 1:
            raise NotImplementedError(
                "steps_per_call > 1 (K train steps per device call) is not "
                "ported yet: it comes with CUDA-graph capture (ROADMAP A8)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.local_batch = cfg.batch_size

        logdir = f"{cfg.logdir}/{cfg.task_name}/{cfg.name}"
        self.logger = logger or Logger(logdir, rank=0, debug=cfg.debug,
                                       step=cfg.step, summary=cfg.visualize,
                                       use_wandb=cfg.wandb)

        self.train_dst, self.val_dst, self.test_dst, _ = get_datasets(
            cfg, base_train, base_val)
        self.train_loader = DataLoader(self.train_dst, self.local_batch,
                                       seed=cfg.random_seed,
                                       workers=cfg.num_workers)
        self.val_loader = DataLoader(
            self.val_dst, self.local_batch if cfg.crop_val else 1,
            shuffle=False, drop_last=False, seed=cfg.random_seed,
            workers=cfg.num_workers)
        if not cfg.test_only and len(self.train_loader) == 0:
            raise ValueError(
                f"train loader is empty ({len(self.train_dst)} filtered "
                f"images, batch size {self.local_batch}, drop_last) — "
                "lower --batch_size, add data, or check the task's "
                "disjoint/--overlap filtering")
        self.total_iters = cfg.epochs * max(len(self.train_loader), 1)

        self.model = make_model(cfg)
        self.model_old = None
        prev_model_state = None
        if cfg.step > 0:
            self.model_old = make_model(cfg, classes=cfg.classes_per_step[:-1])
            path = cfg.step_ckpt or cfg.ckpt_path(cfg.step - 1)
            prev = ckpt_lib.load_model_state(path)
            if prev is None:
                if cfg.debug or cfg.test_only:
                    # eval-only runs need no donor; debug mode allows
                    # training from scratch
                    self.logger.info(
                        f"WARNING: no step-{cfg.step - 1} checkpoint at "
                        f"{path}; continuing without the donor model")
                    self.model_old = None
                else:
                    raise FileNotFoundError(path)
            else:
                prev_model_state = ckpt_lib.state_dict_of(prev)

        # the same-step resume path is resolved BEFORE the pretrained load:
        # a restart after preemption must not fail on a host without
        # pretrained/ when the checkpoint overwrites every parameter anyway
        resume_path = cfg.ckpt
        if resume_path is None and cfg.auto_resume \
                and os.path.exists(cfg.ckpt_path()):
            resume_path = cfg.ckpt_path()
            self.logger.info(f"[!] auto-resume from {resume_path}")

        # the ImageNet-pretrained body, needed only when no previous-step
        # checkpoint supplies the body, and never for eval-only runs or
        # same-step resumes
        pretrained_body = None
        if cfg.pretrained and prev_model_state is None and not cfg.test_only \
                and not (resume_path and os.path.exists(resume_path)):
            from ..models.pretrained import load_pretrained_body
            ppath = cfg.resolve_pretrained_path()
            pretrained_body = load_pretrained_body(ppath)
            if pretrained_body is None:
                msg = (
                    f"pretrained=True but no backbone release file at "
                    f"{ppath!r}. Download the mapillary inplace-abn ImageNet "
                    f"release ({cfg.backbone}_{cfg.norm_act}.pth.tar) into "
                    f"pretrained/, point --pretrained_path at it, or pass "
                    f"--no_pretrained to train from scratch.")
                if cfg.debug:
                    self.logger.info("WARNING: " + msg)
                else:
                    raise FileNotFoundError(msg)

        self.state, self.old_vars = build_train_state(
            cfg, self.model, torch.Generator().manual_seed(cfg.random_seed),
            self.total_iters, prev_model_state=prev_model_state,
            pretrained_body=pretrained_body, device=self.device)
        self.train_step = make_train_step(cfg, self.model, self.model_old,
                                          self.total_iters,
                                          device=self.device)
        self.eval_step = make_eval_step(cfg, self.model, self.model_old,
                                        device=self.device)

        self.cur_epoch = 0
        self.best_score = 0.0
        self.last_val_samples: list = []
        # same-step resume: model, optimizer (momentum + schedule position),
        # epoch and best score; a resumed run is bit-identical to an
        # uninterrupted one
        if resume_path is not None:
            ck = ckpt_lib.load_checkpoint(resume_path)
            if ck is not None:
                ckpt_lib.check_schema(ck, resume_path)
                self.model.load_state_dict(
                    ckpt_lib.state_dict_of(ck["model_state"]), strict=True)
                if not cfg.test_only:
                    # eval-only runs need the variables only: the
                    # optimizer state may have another structure
                    self.state.opt_state = ckpt_lib.restore_like(
                        self.state.opt_state, ck["optimizer_state"])
                self.state.step = int(ck["step"])
                self.cur_epoch = int(ck["epoch"]) + 1
                self.best_score = float(ck["best_score"])
                self.logger.info(f"[!] Model restored from {resume_path}")

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> dict:
        """One pass over the train loader. Returns the epoch's mean of each
        metric, `epoch_time_s`, `images_per_s` and `data_wait_s` (the host
        time the loop waited for the loader's next batch)."""
        cfg = self.cfg
        t0 = time.perf_counter()
        sums, n, since_print, wait = {}, 0, 0, 0.0
        pending: list = []

        def fetch_pending():
            fetched = _fetch(pending)
            pending.clear()
            for fm in fetched:
                for k, v in fm.items():
                    sums[k] = sums.get(k, 0.0) + v
            return fetched

        batches = iter(self.train_loader.epoch(epoch))
        while True:
            tw = time.perf_counter()
            batch = next(batches, None)
            wait += time.perf_counter() - tw
            if batch is None:
                break
            self.state, m = self.train_step(self.state, batch, self.old_vars)
            n += 1
            since_print += 1
            pending.append(m)
            if since_print >= cfg.print_interval:
                since_print = 0
                fetched = fetch_pending()
                avg = float(np.mean([fm["loss_tot"] for fm in fetched]))
                self.logger.info(
                    f"Epoch {epoch}, Batch {n}/{len(self.train_loader)}, "
                    f"Loss={avg:.4f}")
                self.logger.add_scalar(
                    "Loss", avg, epoch * len(self.train_loader) + n)
        fetch_pending()
        dt = time.perf_counter() - t0
        out = {k: v / max(n, 1) for k, v in sums.items()}
        out["epoch_time_s"] = dt
        out["images_per_s"] = n * cfg.batch_size / dt if dt > 0 else 0.0
        out["data_wait_s"] = wait
        return out

    def validate(self, loader=None) -> tuple[dict, dict]:
        cfg = self.cfg
        loader = loader or self.val_loader
        hist = empty_confusion(cfg.tot_classes, self.device)
        sums, n = {}, 0
        pending = []
        # sample panels for the image log: seeded-random ids over the val
        # set (not the stream head, which shows the same images each epoch)
        want = cfg.sample_num if cfg.visualize else 0
        sample_ids: set = set()
        if want > 0:
            srng = np.random.default_rng(cfg.random_seed)
            n_items = len(loader.dataset) if hasattr(loader, "dataset") else 0
            if n_items > 0:
                sample_ids = set(srng.choice(
                    n_items, size=min(want, n_items), replace=False).tolist())
        samples = []
        seen = 0  # real (unpadded) samples consumed so far
        bucket = (not cfg.crop_val) and cfg.eval_bucket_multiple > 0
        for batch in loader.epoch(0):
            if bucket:
                batch = pad_to_bucket(batch, cfg.eval_bucket_multiple)
            hist, losses, preds = self.eval_step(
                None, pad_batch(batch, loader.batch_size), hist,
                self.old_vars)
            n += 1
            pending.append(losses)
            bsz = batch["label"].shape[0]
            for j in range(bsz):
                if seen + j in sample_ids:
                    samples.append((batch["image"][j], batch["label"][j],
                                    preds[j].cpu().numpy()))
            seen += bsz
        # one host fetch after the whole eval stream
        for fm in _fetch(pending):
            for k, v in fm.items():
                sums[k] = sums.get(k, 0.0) + v
        self.last_val_samples = samples
        self.last_confusion = hist.cpu().numpy()
        res = results_from_confusion(self.last_confusion, total_samples=seen)
        return {k: v / max(n, 1) for k, v in sums.items()}, res

    def save(self, epoch: int, score: float):
        cfg = self.cfg
        ckpt_lib.save_checkpoint(cfg.ckpt_path(), self.state, epoch, score,
                                 async_write=cfg.async_ckpt)
        self.logger.info("[!] Checkpoint saved.")

    def run(self, profile_dir: Optional[str] = None) -> dict:
        """The train/val loop with checkpoints; `final_test` follows."""
        cfg = self.cfg
        results = {}
        while self.cur_epoch < cfg.epochs and not cfg.test_only:
            epoch = self.cur_epoch
            if profile_dir and epoch == 0:
                with _profiler(profile_dir, self.device):
                    m = self.train_epoch(epoch)
            else:
                m = self.train_epoch(epoch)
            self.last_train_metrics = m
            self.logger.info(
                f"End of Epoch {epoch}/{cfg.epochs}, Average Loss="
                f"{m.get('loss_tot', 0):.4f} ({m['images_per_s']:.1f} img/s)")
            self.logger.add_scalar("E-Loss", m.get("loss_tot", 0.0), epoch)
            self.logger.add_scalar("E-Loss-cls", m.get("loss", 0.0), epoch)
            self.logger.add_scalar(
                "E-Loss-reg",
                sum(m.get(k, 0.0) for k in ("lkd", "lde", "l_icarl", "l_reg")),
                epoch)
            self.logger.add_scalar("Train-imgs-per-s", m["images_per_s"],
                                   epoch)

            if (epoch + 1) % cfg.val_interval == 0:
                val_losses, val_score = self.validate()
                self.logger.info(results_to_str(val_score))
                score = val_score["Mean IoU"]
                if (epoch + 1) % cfg.ckpt_interval == 0:
                    self.save(epoch, score)
                self.logger.add_scalar("V-Loss", val_losses.get("loss", 0.0),
                                       epoch)
                self.logger.add_scalar("V-Loss-cls",
                                       val_losses.get("loss", 0.0), epoch)
                self.logger.add_scalar(
                    "V-Loss-reg",
                    sum(val_losses.get(k, 0.0) for k in ("lkd", "lde")),
                    epoch)
                self.logger.add_scalar("Val_Overall_Acc",
                                       val_score["Overall Acc"], epoch)
                self.logger.add_scalar("Val_MeanIoU", score, epoch)
                self.logger.add_table("Val_Class_IoU", val_score["Class IoU"],
                                      epoch)
                self.logger.add_table("Val_Acc_IoU", val_score["Class Acc"],
                                      epoch)
                # validation sample panels: (input | GT | prediction)
                for k, (img, tgt, pred) in enumerate(self.last_val_samples):
                    panel = compose_sample_png(np.asarray(img),
                                               np.asarray(tgt), pred,
                                               cfg.dataset)
                    self.logger.add_image(f"Sample_{k}",
                                          panel.transpose(2, 0, 1), epoch)
                results["V-IoU"] = val_score["Class IoU"]
                results["V-Acc"] = val_score["Class Acc"]
                self.best_score = max(self.best_score, score)
            self.cur_epoch += 1

        if not cfg.test_only:
            self.save(self.cur_epoch - 1, self.best_score)
        return results

    @torch.no_grad()
    def visualize(self, out_dir: str, max_images: int = 16) -> int:
        """Dump per-image (input | GT | prediction) panels, body-attention
        maps, the raw-id and colorized prediction and target, and the RGB
        input. Returns the number of images written."""
        from PIL import Image

        from ..ops import fused_eval as FE
        from ..utils.viz import (Denormalize, Label2Color, attention_map,
                                 color_map)

        os.makedirs(out_dir, exist_ok=True)
        cfg = self.cfg
        l2c = Label2Color(color_map(cfg.dataset))
        self.model.eval()
        n = 0
        loader = DataLoader(self.test_dst, cfg.batch_size, shuffle=False,
                            drop_last=False, seed=cfg.random_seed)
        for batch in loader.epoch(0):
            x = torch.as_tensor(batch["image"]).to(self.device)
            x = x.permute(0, 3, 1, 2)
            feats = self.model.forward_feats(x, attention=True)
            sem = feats["sem"].permute(0, 2, 3, 1).contiguous()
            hw = tuple(x.shape[2:])
            if cfg.fused_loss and FE.supported(sem.shape, hw):
                preds = FE.fused_argmax(sem, hw)
            else:
                preds = _resize_argmax(feats["sem"], hw)
            preds = preds.cpu().numpy()
            body = feats["body"].permute(0, 2, 3, 1).float().cpu().numpy()
            att = attention_map(body, batch["image"].shape[1:3])
            for j in range(preds.shape[0]):
                panel = compose_sample_png(batch["image"][j],
                                           batch["label"][j], preds[j],
                                           cfg.dataset)
                Image.fromarray(panel).save(
                    os.path.join(out_dir, f"{n:04d}_panel.png"))
                a = (att[j] / max(float(att[j].max()), 1e-12) * 255)
                Image.fromarray(a.astype(np.uint8)).save(
                    os.path.join(out_dir, f"{n:04d}_attention.png"))
                tgt = np.asarray(batch["label"][j])
                pre = f"{n:04d}"
                Image.fromarray(preds[j].astype(np.uint8)).save(
                    os.path.join(out_dir, pre + "pre.png"))
                Image.fromarray(np.clip(tgt, 0, 255).astype(np.uint8)).save(
                    os.path.join(out_dir, pre + "gt.jpg"))
                Image.fromarray(l2c(preds[j]).astype(np.uint8)).save(
                    os.path.join(out_dir, pre + "pre_clo.png"))
                Image.fromarray(l2c(tgt).astype(np.uint8)).save(
                    os.path.join(out_dir, pre + "gt_clo.jpg"))
                img_j = np.asarray(batch["image"][j])
                rgb = (img_j if img_j.dtype == np.uint8
                       else (Denormalize()(img_j) * 255).astype(np.uint8))
                Image.fromarray(rgb).save(
                    os.path.join(out_dir, pre + "rgb.jpg"))
                n += 1
                if n >= max_images:
                    return n
        return n

    def close(self):
        """Release the loaders' worker pools and wait for an in-flight
        checkpoint write (re-raising its error)."""
        self.train_loader.close()
        self.val_loader.close()
        ckpt_lib.wait_pending()

    def predict_test(self) -> dict:
        """Test-time-augmented eval through engine.predictor.Predictor:
        multi-scale / flipped views fused by `cfg.fusion_mode`."""
        from .metrics import confusion_matrix_update
        from .predictor import Predictor
        cfg = self.cfg
        predictor = Predictor(self.model, fusion_mode=cfg.fusion_mode,
                              flip=cfg.test_flip, scales=cfg.test_scales,
                              fused=cfg.fused_loss, device=self.device)
        hist = empty_confusion(cfg.tot_classes, self.device)
        loader = DataLoader(self.test_dst,
                            cfg.batch_size if cfg.crop_val else 1,
                            shuffle=False, drop_last=False,
                            seed=cfg.random_seed)
        n = 0
        for batch in loader.epoch(0):
            preds = predictor.predict_labels(batch["image"])
            labels = torch.as_tensor(batch["label"]).to(self.device)
            hist = confusion_matrix_update(hist, labels, preds,
                                           cfg.tot_classes)
            n += batch["label"].shape[0]
        score = results_from_confusion(hist, total_samples=n)
        self.logger.info(results_to_str(score))
        return score

    def final_test(self) -> dict:
        """Test on all seen classes."""
        cfg = self.cfg
        test_loader = DataLoader(self.test_dst,
                                 self.local_batch if cfg.crop_val else 1,
                                 shuffle=False, drop_last=False,
                                 seed=cfg.random_seed)
        losses, score = self.validate(test_loader)
        self.logger.info(results_to_str(score))
        if cfg.visualize:
            self._save_confusion_figure()
        self.logger.add_scalar("T_Overall_Acc", score["Overall Acc"],
                               cfg.step)
        self.logger.add_scalar("T_MeanIoU", score["Mean IoU"], cfg.step)
        self.logger.add_scalar("T_MeanAcc", score["Mean Acc"], cfg.step)
        self.logger.add_table("Test_Class_IoU", score["Class IoU"])
        return score

    def _save_confusion_figure(self):
        """The confusion-matrix PNG beside the logs; skipped, with a note,
        on a host without matplotlib (an optional sink, like TensorBoard)."""
        from .metrics import confusion_matrix_figure
        cfg = self.cfg
        out = f"{cfg.logdir}/{cfg.task_name}/{cfg.name}"
        os.makedirs(out, exist_ok=True)
        try:
            confusion_matrix_figure(
                self.last_confusion,
                save_path=f"{out}/confusion_matrix_step{cfg.step}.png")
        except ImportError:
            self.logger.info("matplotlib is not installed: no confusion-"
                             "matrix figure")


def _resize_argmax(sem: torch.Tensor, hw) -> torch.Tensor:
    """(B, H, W) int32 argmax of NCHW low-res logits upsampled to `hw`."""
    from ..models.segmentation import resize_bilinear
    return resize_bilinear(sem, hw).argmax(dim=1).to(torch.int32)


@contextlib.contextmanager
def _profiler(out_dir: str, device: torch.device):
    """torch.profiler over a block; the chrome trace goes to `out_dir`."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "train_epoch0.json"))
