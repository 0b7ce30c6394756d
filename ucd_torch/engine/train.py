"""The training engine: the train step (donor forward, train-mode forward,
loss terms, backward, masked nesterov SGD) and the validate step.

Counterpart of ucd_tpu/engine/train.py. Differences by design:

  * PyTorch runs eagerly and updates in place: `TrainState` refers to the
    model that owns the parameters and the BatchNorm statistics, the step
    mutates them and returns the same state object;
  * the frozen donor is `model_old` evaluated on `old_vars` (a state_dict)
    through `torch.func.functional_call`, in eval mode under
    `torch.no_grad()`;
  * frozen parameters have `requires_grad=False`, so autograd computes no
    gradient for them and the optimizer never sees them: they receive no
    update and no weight decay (the JAX step masks gradients and updates);
  * neither step computes the full-res upsample unless the dense path
    needs it (`model.forward_feats`); the fused path reads the low-res
    logits only.

Ported branches: fused CE/KD, dense CE/unCE, dense KD/unKD, `lde` and the
UCD pixel-contrastive term (`cfg.contrastive`, what `--method UCD` adds to
the MiB preset): built from the attended `pre_logits` of both models and
the donor's logits, through the streaming kernels of
ops/tiled_contrastive.py under `cfg.use_pallas_contrastive` (in bf16 mode
under the bf16 policy) or the dense loss of ops/contrastive.py without it.
The validate step computes no contrastive term, as on the JAX side. The
`icarl`, `bce` and regularizer branches raise NotImplementedError naming
their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch.func import functional_call

from ..config import Config, unsupported_fields
from ..device import resolve_device
from ..models.layers import wide_dtype
from ..models.segmentation import resize_bilinear, trainable_mask
from ..ops import fused_eval as FE
from ..ops import fused_loss as FL
from ..ops import losses as L
from ..ops.contrastive import ucd_contrastive_loss
from .metrics import confusion_matrix_update

MAX_CONSECUTIVE_NONFINITE = 100


@dataclasses.dataclass
class TrainState:
    """`model` owns the parameters and the BatchNorm statistics;
    `opt_state` is {"trace": name -> momentum buffer, "count": applied
    updates, "nonfinite": consecutive skipped updates}; `step` counts calls
    of the train step."""
    model: torch.nn.Module
    opt_state: Dict[str, Any]
    reg_state: Optional[Any] = None
    step: int = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())


def make_lr_schedule(cfg: Config, total_iters: int):
    """PolyLR stepped per iteration, or StepLR: `lr(count)`, count from 0."""
    if cfg.lr_policy == "poly":
        def sched(count):
            frac = 1.0 - count / max(total_iters, 1)
            return cfg.lr * max(frac, 0.0) ** cfg.lr_power
        return sched

    def sched(count):
        return cfg.lr * cfg.lr_decay_factor ** (count // cfg.lr_decay_step)
    return sched


class Optimizer:
    """SGD(momentum, nesterov) with coupled weight decay: the decay is
    added to the gradient of every parameter it is given (BN and biases
    included) before the momentum. With `cfg.nan_guard` an update whose
    gradients are not all finite is skipped whole (after
    MAX_CONSECUTIVE_NONFINITE skips in a row it is applied anyway), and
    the schedule does not advance."""

    def __init__(self, cfg: Config, total_iters: int):
        self.sched = make_lr_schedule(cfg, total_iters)
        self.weight_decay = cfg.weight_decay
        self.momentum = cfg.momentum
        self.nan_guard = bool(cfg.nan_guard)

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        return {"trace": {k: torch.zeros_like(p) for k, p in params.items()},
                "count": 0, "nonfinite": 0}

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor],
               opt_state: Dict[str, Any]) -> bool:
        """In-place update of `params` (those named in `grads`) and of
        `opt_state`. Returns whether the update was applied."""
        names = list(grads)
        if not names:
            return True
        g = [grads[k] for k in names]
        if self.nan_guard:
            finite = bool(torch.stack(torch._foreach_norm(g)).isfinite()
                          .all())
            opt_state["nonfinite"] = 0 if finite \
                else opt_state["nonfinite"] + 1
            if not finite and \
                    opt_state["nonfinite"] <= MAX_CONSECUTIVE_NONFINITE:
                return False
        p = [params[k] for k in names]
        trace = [opt_state["trace"][k] for k in names]
        lr = self.sched(opt_state["count"])
        g = torch._foreach_add(g, p, alpha=self.weight_decay)
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, g)
        torch._foreach_add_(g, trace, alpha=self.momentum)  # nesterov
        torch._foreach_add_(p, g, alpha=-lr)
        opt_state["count"] += 1
        return True


def make_optimizer(cfg: Config, total_iters: int) -> Optimizer:
    return Optimizer(cfg, total_iters)


def _fused_gate(cfg: Config, sem_shape, label_shape, kd_on: bool):
    """Shared fused-kernel gating for train and eval: (ce_mode, kd_mode,
    use_fused). The fused path computes the criterion and the KD term
    straight from the low-res logits; bce/icarl configs keep the dense
    path."""
    ce_mode = "unce" if (cfg.unce and cfg.old_classes != 0) else "ce"
    kd_mode = ("unkd" if cfg.unkd else "kd") if kd_on else "none"
    use_fused = (cfg.fused_loss
                 and not (cfg.bce or cfg.icarl)
                 and FL.supported(sem_shape, label_shape, ce_mode, kd_mode))
    return ce_mode, kd_mode, use_fused


def _dense_outputs(cfg: Config, sem: torch.Tensor, hw) -> torch.Tensor:
    """Full-res NHWC logits from the low-res NHWC `sem`: the dense path's
    explicit upsample, in bf16 under `bf16_upsample` and the bf16 policy."""
    dtype = torch.bfloat16 \
        if cfg.bf16_upsample and cfg.dtype == "bfloat16" \
        else wide_dtype(sem.dtype)
    return resize_bilinear(sem.permute(0, 3, 1, 2), hw,
                           dtype=dtype).permute(0, 2, 3, 1)


def _dense_criterion(cfg: Config, outputs, labels, outputs_old,
                     icarl_only_dist: bool):
    """Dense full-res criterion selection."""
    if icarl_only_dist or cfg.bce or cfg.icarl:
        raise NotImplementedError(
            "the icarl and bce criteria are not ported yet (ROADMAP A7)")
    labels = labels.long()
    if cfg.unce and cfg.old_classes != 0:
        return L.unbiased_cross_entropy(outputs, labels, cfg.old_classes)
    return L.cross_entropy(outputs, labels)


def _dense_kd(cfg: Config, outputs, outputs_old):
    kd_fn = (L.unbiased_knowledge_distillation if cfg.unkd
             else L.knowledge_distillation)
    return kd_fn(outputs, outputs_old, alpha=cfg.alpha)


def _lde(feats, feats_old):
    return (L.feature_distillation(feats["body"], feats_old["body"])
            + L.feature_distillation(feats["pre_logits"],
                                     feats_old["pre_logits"]))


def compute_train_losses(cfg: Config, outputs, feats, labels,
                         outputs_old=None, feats_old=None):
    """All loss terms of the hot loop. `feats` / `feats_old` hold NHWC
    tensors ("sem", and the attended "body" / "pre_logits" where `loss_de`
    or the contrastive term asks for them); `feats_old` is None without a
    donor. `outputs` / `outputs_old` are the full-res NHWC logits or None:
    the dense branches upsample `sem` themselves when they are missing."""
    has_old = feats_old is not None
    if cfg.icarl and has_old:
        raise NotImplementedError(
            "the icarl terms are not ported yet (ROADMAP A7)")
    sem = feats["sem"]
    hw = tuple(labels.shape[1:3])
    zero = torch.zeros((), dtype=wide_dtype(sem.dtype), device=sem.device)
    terms: Dict[str, torch.Tensor] = {}

    kd_on = cfg.loss_kd > 0 and has_old
    ce_mode, kd_mode, use_fused = _fused_gate(cfg, sem.shape, labels.shape,
                                              kd_on)
    lkd = zero
    if use_fused:
        loss, kd_raw = FL.fused_ce_kd(
            sem, labels, feats_old["sem"] if kd_on else None,
            old_cl=cfg.old_classes, ce_mode=ce_mode, kd_mode=kd_mode,
            alpha=cfg.alpha)
        if kd_on:
            lkd = cfg.loss_kd * kd_raw
    else:
        if outputs is None:
            outputs = _dense_outputs(cfg, sem, hw)
        loss = _dense_criterion(cfg, outputs, labels, outputs_old, False)
        if kd_on:
            if outputs_old is None:
                outputs_old = _dense_outputs(cfg, feats_old["sem"], hw)
            lkd = cfg.loss_kd * _dense_kd(cfg, outputs, outputs_old)
    terms["loss"] = loss

    # UCD pixel-contrastive distillation
    l_con = zero
    if cfg.contrastive and has_old:
        l_con = ucd_contrastive_loss(
            feats["pre_logits"], labels, feats_old["sem"],
            feats_old["pre_logits"], max_label=cfg.num_classes - 1,
            temperature=cfg.temperature,
            capacity=cfg.contrastive_capacity,
            use_pallas=cfg.use_pallas_contrastive,
            bug_compatible=cfg.contrastive_bug_compatible,
            # bf16 training: the kernels multiply bf16-rounded features;
            # f32 (and the f64 test dtype) keep the exact path
            kernel_dtype=(torch.bfloat16 if cfg.dtype == "bfloat16"
                          else torch.float32),
        ) * cfg.contrastive_weight
    terms["l_con"] = l_con
    terms["l_icarl"] = zero

    lde = zero
    if cfg.loss_de > 0 and has_old:
        lde = cfg.loss_de * _lde(feats, feats_old)
    terms["lde"] = lde
    terms["lkd"] = lkd
    terms["loss_tot"] = loss + l_con + lde + lkd
    return terms


def _check_cfg(cfg: Config):
    bad = unsupported_fields(cfg)
    if bad:
        raise NotImplementedError(
            f"config fields {bad} steer the TPU execution of the JAX "
            f"package; the port implements only their defaults")
    if cfg.regularizer is not None:
        raise NotImplementedError(
            "the EWC/PI/RW regularizers are not ported yet (ROADMAP A7)")


def _step_device(device, model, model_old) -> torch.device:
    """The device a step runs on: CUDA unless the caller names one. The
    model must already be there (`build_train_state` moves it, and the
    optimizer state lies beside it), so a model elsewhere raises; the
    donor module is only a shell for `old_vars` and is moved."""
    dev = resolve_device(device)
    for p in model.parameters():
        if p.device.type != dev.type or (
                dev.index is not None and p.device.index != dev.index):
            raise ValueError(
                f"the model is on {p.device} but the step runs on {dev}: "
                f"move the model there (build_train_state does) or pass "
                f"device={str(p.device.type)!r}")
    if model_old is not None:
        model_old.to(device=dev, memory_format=torch.channels_last)
    return dev


def _batch(batch, device):
    """(NCHW view of the NHWC images, labels), on `device`."""
    images = torch.as_tensor(batch["image"]).to(device, non_blocking=True)
    labels = torch.as_tensor(batch["label"]).to(device, non_blocking=True)
    return images.permute(0, 3, 1, 2), labels


def _nhwc(feats: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.permute(0, 2, 3, 1).contiguous() if k == "sem"
            else v.permute(0, 2, 3, 1) for k, v in feats.items()}


def make_train_step(cfg: Config, model, model_old, total_iters: int,
                    step_idx: Optional[int] = None, device=None,
                    mark: Optional[Callable[[str], None]] = None):
    """Build the train step. `model_old` is None at step 0. The step runs
    on `device`: CUDA unless the caller passes one, and `model` must
    already be there.

    Returns fn(state, batch, old_vars=None) -> (state, metrics) where
    batch = {'image': (B,H,W,3) uint8 or float, 'label': (B,H,W) uint8 or
    int}, tensors or numpy arrays, and old_vars is the donor's state_dict
    (or None). `state.model` must be `model`; it is updated in place.
    The metrics are 0-d tensors on the device, plus `lr`, the schedule at
    the step's index (as the JAX step reports it; after an update that
    `nan_guard` skipped, the applied rate lags it by the skipped count).

    `mark(name)`, if given, is called at the start of the step and after
    each of its parts ("start", "upload", "donor_forward", "forward",
    "losses", "backward", "optimizer"), for a caller that times the parts
    (a CUDA event per call)."""
    _check_cfg(cfg)
    dev = _step_device(device, model, model_old)
    mark = mark or (lambda name: None)
    step_idx = cfg.step if step_idx is None else step_idx
    if cfg.dataset == "city_domain":
        step_idx = 0  # single fixed head keeps training (domain-incremental)
    tx = make_optimizer(cfg, total_iters)
    has_old = model_old is not None
    # the contrastive term reads the attended pre_logits of both models
    need_att = (cfg.loss_de > 0 or cfg.contrastive) and has_old

    mask = trainable_mask(
        [n for n, _ in model.named_parameters()], step_idx,
        freeze_body=cfg.freeze, fix_bn=cfg.fix_bn,
        freeze_cls0_always=cfg.freeze_cls0_always)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    if has_old:
        model_old.eval().requires_grad_(False)

    def train_step(state: TrainState, batch, old_vars=None):
        if state.model is not model:
            raise ValueError("state.model is not the model this step was "
                             "built for")
        mark("start")
        x, labels = _batch(batch, dev)
        mark("upload")

        feats_old = None
        if has_old:
            # frozen donor forward, eval mode
            with torch.no_grad():
                _, feats_old = functional_call(
                    model_old, old_vars, (x,),
                    {"upsample": False, "attention": need_att})
            feats_old = _nhwc(feats_old)
        mark("donor_forward")

        model.train(not cfg.fix_bn)
        feats = _nhwc(model.forward_feats(x, attention=need_att))
        mark("forward")
        terms = compute_train_losses(cfg, None, feats, labels, None,
                                     feats_old)
        mark("losses")
        params = {n: p for n, p in model.named_parameters() if mask[n]}
        for p in params.values():
            p.grad = None
        terms["loss_tot"].backward()
        mark("backward")
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        tx.update(params, grads, state.opt_state)
        mark("optimizer")

        metrics = {k: v.detach() for k, v in terms.items()}
        metrics["l_reg"] = torch.zeros_like(metrics["loss_tot"])
        metrics["lr"] = tx.sched(state.step)
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(cfg: Config, model, model_old=None, device=None):
    """Validate step: criterion loss + distillation terms for logging,
    argmax prediction, confusion-matrix update. It runs on `device`: CUDA
    unless the caller passes one, and `model` must already be there.

    Returns fn(variables, batch, hist, old_vars=None) ->
    (hist, {"loss", "lkd", "lde"}, preds). `variables` is a state_dict to
    evaluate `model` on, or None for the model's own tensors."""
    _check_cfg(cfg)
    dev = _step_device(device, model, model_old)
    has_old = model_old is not None
    n_classes = cfg.tot_classes
    if has_old:
        model_old.eval()

    @torch.no_grad()
    def eval_step(variables, batch, hist, old_vars=None):
        x, labels = _batch(batch, dev)
        hw = tuple(labels.shape[1:3])
        use_old = has_old and old_vars is not None
        need_att = cfg.loss_de > 0 and use_old
        model.eval()
        kw = {"upsample": False, "attention": need_att}
        if variables is None:
            _, feats = model(x, **kw)
        else:
            _, feats = functional_call(model, variables, (x,), kw)
        feats = _nhwc(feats)
        feats_old = None
        if use_old:
            _, feats_old = functional_call(model_old, old_vars, (x,), kw)
            feats_old = _nhwc(feats_old)
        sem = feats["sem"]

        kd_on = cfg.loss_kd > 0 and use_old
        ce_mode, kd_mode, use_fused = _fused_gate(cfg, sem.shape,
                                                  labels.shape, kd_on)
        use_fused = use_fused and FE.supported(sem.shape, hw)

        lkd = lde = torch.zeros((), dtype=wide_dtype(sem.dtype),
                                device=sem.device)
        if need_att:
            lde = _lde(feats, feats_old)

        if use_fused:
            loss, lkd_raw = FL.fused_ce_kd(
                sem, labels, feats_old["sem"] if kd_on else None,
                old_cl=cfg.old_classes, ce_mode=ce_mode, kd_mode=kd_mode,
                alpha=cfg.alpha)
            if kd_on:
                lkd = lkd_raw  # unscaled, logging only
            preds = FE.fused_argmax(sem, hw)
        else:
            outputs = _dense_outputs(cfg, sem, hw)
            icarl_only_dist = cfg.icarl and cfg.icarl_disjoint and has_old
            loss = _dense_criterion(cfg, outputs, labels, None,
                                    icarl_only_dist)
            if kd_on:
                # unscaled, logging only
                lkd = _dense_kd(cfg, outputs,
                                _dense_outputs(cfg, feats_old["sem"], hw))
            preds = outputs.argmax(dim=-1).to(torch.int32)

        hist = confusion_matrix_update(hist, labels, preds, n_classes)
        return hist, {"loss": loss, "lkd": lkd, "lde": lde}, preds

    return eval_step


__all__ = ["TrainState", "Optimizer", "make_lr_schedule",
           "make_optimizer", "compute_train_losses", "make_train_step",
           "make_eval_step"]
