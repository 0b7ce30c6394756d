"""The training engine: the train step (donor forward, train-mode forward,
loss terms, backward, regularizer, masked nesterov SGD), K steps per call
(`make_train_bundle`, a CUDA graph on the card) and the validate step.

Counterpart of ucd_tpu/engine/train.py. Differences by design:

  * PyTorch runs eagerly and updates in place: `TrainState` refers to the
    model that owns the parameters and the BatchNorm statistics, the step
    mutates them and returns the same state object. Every other piece of
    state is a tensor on the device updated in place too (the momentum
    buffers, the schedule's count, `nan_guard`'s skip count, the call
    count `step`, the regularizer's accumulators), so one code path serves
    the eager step and the captured one;
  * the frozen donor is `model_old` evaluated on `old_vars` (a state_dict)
    through `torch.func.functional_call`, in eval mode under
    `torch.no_grad()`;
  * frozen parameters have `requires_grad=False`, so autograd computes no
    gradient for them and the optimizer never sees them: they receive no
    update and no weight decay (the JAX step masks gradients and updates).
    Under a regularizer every parameter takes a gradient, since its
    accumulators read the unmasked gradients as on the JAX side;
  * neither step computes the full-res upsample unless the dense path
    needs it (`model.forward_feats`); the fused path reads the low-res
    logits only;
  * `make_train_bundle` captures one step in a CUDA graph and replays it
    once per batch (the JAX package scans the step under `jit`).

Every branch of the JAX step is ported: fused CE/KD, dense CE/unCE, BCE,
the iCaRL criteria and term, dense KD/unKD, `lde`, the UCD
pixel-contrastive term (`cfg.contrastive`, what `--method UCD` adds to the
MiB preset) through the streaming kernels of ops/tiled_contrastive.py
under `cfg.use_pallas_contrastive` or the dense loss of ops/contrastive.py
without it, and the EWC/PI/RW regularizers of ops/regularizers.py. The
validate step computes no contrastive term, as on the JAX side.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch.func import functional_call

from .. import parallel as P
from ..config import Config, unsupported_fields
from ..device import resolve_device
from ..models.layers import use_mesh, wide_dtype
from ..models.segmentation import resize_bilinear, trainable_mask
from ..ops import fused_eval as FE
from ..ops import fused_loss as FL
from ..ops import losses as L
from ..ops import regularizers as R
from ..ops import tiled_contrastive as TT
from ..ops.contrastive import ucd_contrastive_loss
from ..utils import tracing
from .metrics import confusion_matrix_update

MAX_CONSECUTIVE_NONFINITE = 100


@dataclasses.dataclass
class TrainState:
    """`model` owns the parameters and the BatchNorm statistics;
    `opt_state` is {"trace": name -> momentum buffer, "count": applied
    updates, "nonfinite": consecutive skipped updates}, the counts 0-d
    int64 tensors on the device; `reg_state` the regularizer's
    (ops/regularizers.py) or None; `step` a 0-d int64 device tensor that
    counts calls of the train step."""
    model: torch.nn.Module
    opt_state: Dict[str, Any]
    reg_state: Optional[R.RegState] = None
    step: Any = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())


def make_lr_schedule(cfg: Config, total_iters: int):
    """PolyLR stepped per iteration, or StepLR: `lr(count, dtype)`, count
    from 0 (a tensor, on the device for the train step, or a number). The
    result is a 0-d tensor of `dtype` (f32 unless given) beside `count`,
    computed in that dtype as the JAX schedule computes in f32 (its `pow`
    may round 1 ulp apart)."""
    def as_tensor(count):
        return count if isinstance(count, torch.Tensor) \
            else torch.as_tensor(count)

    if cfg.lr_policy == "poly":
        def sched(count, dtype=torch.float32):
            frac = 1.0 - as_tensor(count).to(dtype) / max(total_iters, 1)
            return torch.clamp_min(frac, 0.0) ** cfg.lr_power * cfg.lr
        return sched

    def sched(count, dtype=torch.float32):
        k = torch.div(as_tensor(count), cfg.lr_decay_step,
                      rounding_mode="floor").to(dtype)
        return torch.pow(cfg.lr_decay_factor, k) * cfg.lr
    return sched


class Optimizer:
    """SGD(momentum, nesterov) with coupled weight decay: the decay is
    added to the gradient of every parameter it is given (BN and biases
    included) before the momentum; the update is then p - lr * u, optax's
    `p + (-lr * u)`. The schedule reads the count on the device. With
    `cfg.nan_guard` an update whose gradients are not all finite is skipped
    whole by a select on the device (params, momentum and count unchanged,
    `nonfinite` incremented; the update after MAX_CONSECUTIVE_NONFINITE
    skips in a row is applied anyway; a finite one resets `nonfinite`):
    optax.apply_if_finite(max_consecutive_errors=100). On a 2-D mesh,
    where a rank updates its shards only, `group` is its model group: the
    finite test then reads every shard of the group's gradients, so the
    group's ranks skip or apply together."""

    def __init__(self, cfg: Config, total_iters: int, group=None):
        self.sched = make_lr_schedule(cfg, total_iters)
        self.weight_decay = cfg.weight_decay
        self.momentum = cfg.momentum
        self.nan_guard = bool(cfg.nan_guard)
        self.group = group

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        device = next(iter(params.values())).device
        return {"trace": {k: torch.zeros_like(p) for k, p in params.items()},
                "count": torch.zeros((), dtype=torch.int64, device=device),
                "nonfinite": torch.zeros((), dtype=torch.int64,
                                         device=device)}

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor],
               opt_state: Dict[str, Any]) -> None:
        """In-place update of `params` (those named in `grads`) and of
        `opt_state`, with no host synchronization."""
        names = list(grads)
        if not names:
            return
        g0 = [grads[k] for k in names]
        p = [params[k] for k in names]
        trace = [opt_state["trace"][k] for k in names]
        count = opt_state["count"]
        lr = self.sched(count, p[0].dtype)
        g = torch._foreach_add(g0, p, alpha=self.weight_decay)
        if not self.nan_guard:
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, g)
            torch._foreach_add_(g, trace, alpha=self.momentum)  # nesterov
            torch._foreach_mul_(g, lr)
            torch._foreach_sub_(p, g)
            count.add_(1)
            return
        # max |g| is finite iff every tensor is
        gmax = torch.stack(torch._foreach_norm(g0, ord=float("inf"))).max()
        if self.group is not None:
            # NaN as inf: a MAX reduction may drop a NaN, never an inf
            gmax = P.all_reduce_max_(
                torch.where(gmax.isnan(), float("inf"), gmax), self.group)
        finite = gmax.isfinite()
        nonfinite = opt_state["nonfinite"]
        nonfinite.copy_(torch.where(finite, 0, nonfinite + 1))
        apply = finite | (nonfinite > MAX_CONSECUTIVE_NONFINITE)
        new_trace = torch._foreach_mul(trace, self.momentum)
        torch._foreach_add_(new_trace, g)
        torch._foreach_add_(g, new_trace, alpha=self.momentum)
        torch._foreach_mul_(g, lr)
        new_p = torch._foreach_sub(p, g)
        for dst, src in zip(p + trace, new_p + new_trace):
            dst.copy_(torch.where(apply, src, dst))
        count.add_(apply)


def make_optimizer(cfg: Config, total_iters: int, group=None) -> Optimizer:
    return Optimizer(cfg, total_iters, group)


def _fused_gate(cfg: Config, sem_shape, label_shape, old_shape, device):
    """Shared fused-kernel gating for train and eval: (ce_mode, kd_mode,
    use_fused). The fused path computes the criterion and the KD term
    straight from the low-res logits; bce/icarl configs keep the dense
    path, and so do class counts beyond the kernels on `device`.
    `old_shape` is the donor's low-res logits' shape when KD is on, else
    None."""
    ce_mode = "unce" if (cfg.unce and cfg.old_classes != 0) else "ce"
    kd_mode = ("unkd" if cfg.unkd else "kd") if old_shape is not None \
        else "none"
    use_fused = (cfg.fused_loss
                 and not (cfg.bce or cfg.icarl)
                 and FL.supported(sem_shape, label_shape, ce_mode, kd_mode,
                                  None if old_shape is None
                                  else old_shape[-1], device))
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
    labels = labels.long()
    if icarl_only_dist:
        return L.icarl_loss(outputs, labels,
                            torch.sigmoid(outputs_old.to(
                                wide_dtype(outputs_old.dtype))),
                            bkg=cfg.icarl_bkg)
    if cfg.bce or cfg.icarl:
        return L.bce_with_logits_ignore(outputs, labels,
                                        reduction="mean_all")
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
                         outputs_old=None, feats_old=None, data_group=None):
    """All loss terms of the hot loop. `feats` / `feats_old` hold NHWC
    tensors ("sem", and the attended "body" / "pre_logits" where `loss_de`
    or the contrastive term asks for them); `feats_old` is None without a
    donor. `outputs` / `outputs_old` are the full-res NHWC logits or None:
    the dense branches upsample `sem` themselves when they are missing.
    `data_group` is the process group the batch is split over (None: the
    world; the data group on a 2-D mesh)."""
    has_old = feats_old is not None
    icarl_combined = cfg.icarl and not cfg.icarl_disjoint and has_old
    icarl_only_dist = cfg.icarl and cfg.icarl_disjoint and has_old
    sem = feats["sem"]
    hw = tuple(labels.shape[1:3])
    zero = torch.zeros((), dtype=wide_dtype(sem.dtype), device=sem.device)
    terms: Dict[str, torch.Tensor] = {}

    kd_on = cfg.loss_kd > 0 and has_old
    ce_mode, kd_mode, use_fused = _fused_gate(
        cfg, sem.shape, labels.shape,
        feats_old["sem"].shape if kd_on else None, sem.device)
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
        if has_old and outputs_old is None and (
                kd_on or cfg.icarl):
            outputs_old = _dense_outputs(cfg, feats_old["sem"], hw)
        loss = _dense_criterion(cfg, outputs, labels, outputs_old,
                                icarl_only_dist)
        if kd_on:
            lkd = cfg.loss_kd * _dense_kd(cfg, outputs, outputs_old)
    terms["loss"] = loss

    # UCD pixel-contrastive distillation (off under iCaRL's disjoint mode)
    l_con = zero
    if cfg.contrastive and has_old and not icarl_only_dist:
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
            group=data_group,
        ) * cfg.contrastive_weight
    terms["l_con"] = l_con

    # iCaRL combined: BCE of the old classes against sigmoid(old logits)
    l_icarl = zero
    if icarl_combined:
        l_icarl = L.icarl_combined_loss(outputs, outputs_old,
                                        cfg.icarl_importance)
    terms["l_icarl"] = l_icarl

    lde = zero
    if cfg.loss_de > 0 and has_old:
        lde = cfg.loss_de * _lde(feats, feats_old)
    terms["lde"] = lde
    terms["lkd"] = lkd
    terms["loss_tot"] = loss + l_con + l_icarl + lde + lkd
    return terms


def _check_cfg(cfg: Config):
    bad = unsupported_fields(cfg)
    if bad:
        raise NotImplementedError(
            f"config fields {bad} steer the TPU backend of the JAX "
            f"package; the port implements only their defaults")


def _step_device(device, model, model_old) -> torch.device:
    """The device a step runs on: CUDA unless the caller names one. The
    model must already be there (`build_train_state` moves it, and the
    optimizer state lies beside it), so a model elsewhere raises; the
    donor module is only a shell for `old_vars` and is moved: to `device`,
    or, beside a model on the 2-D mesh, whose `old_vars` are this rank's
    shards of every donor tensor, to the meta device, where it holds no
    memory."""
    dev = resolve_device(device)
    for p in model.parameters():
        if p.device.type != dev.type or (
                dev.index is not None and p.device.index != dev.index):
            raise ValueError(
                f"the model is on {p.device} but the step runs on {dev}: "
                f"move the model there (build_train_state does) or pass "
                f"device={str(p.device.type)!r}")
    if model_old is not None:
        model_old.to(device="meta" if getattr(model, "mesh", None)
                     is not None else dev,
                     memory_format=torch.channels_last)
    return dev


def _batch(batch, device):
    """(NCHW view of the NHWC images, labels), on `device`."""
    images = torch.as_tensor(batch["image"]).to(device, non_blocking=True)
    labels = torch.as_tensor(batch["label"]).to(device, non_blocking=True)
    return images.permute(0, 3, 1, 2), labels


def _nhwc(feats: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.permute(0, 2, 3, 1).contiguous() if k == "sem"
            else v.permute(0, 2, 3, 1) for k, v in feats.items()}


def _make_core(cfg: Config, model, model_old, total_iters: int,
               step_idx: Optional[int]):
    """The step after the upload, shared by `make_train_step` and
    `make_train_bundle`: core(state, x, labels, old_vars, mark) ->
    metrics, with x the NCHW view of the images and labels on the model's
    device and `mark` a `tracing.PhaseMark`. It reads and writes only
    device tensors that live in `state`, the model and `old_vars`, and
    never synchronizes with the host."""
    _check_cfg(cfg)
    step_idx = cfg.step if step_idx is None else step_idx
    if cfg.dataset == "city_domain":
        step_idx = 0  # single fixed head keeps training (domain-incremental)
    has_old = model_old is not None
    # the contrastive term reads the attended pre_logits of both models
    need_att = (cfg.loss_de > 0 or cfg.contrastive) and has_old
    mesh = getattr(model, "mesh", None)
    data_group = model_group = None
    if mesh is not None:
        data_group, model_group = mesh.data_group, mesh.model_group
        if has_old:
            use_mesh(model_old, mesh)
    tx = make_optimizer(cfg, total_iters, model_group)

    mask = trainable_mask(
        [n for n, _ in model.named_parameters()], step_idx,
        freeze_body=cfg.freeze, fix_bn=cfg.fix_bn,
        freeze_cls0_always=cfg.freeze_cls0_always)
    reg = cfg.regularizer is not None
    for name, p in model.named_parameters():
        # a regularizer's accumulators read every parameter's gradient
        p.requires_grad_(mask[name] or reg)
    if has_old:
        model_old.eval().requires_grad_(False)

    def core(state: TrainState, x, labels, old_vars, mark):
        if state.model is not model:
            raise ValueError("state.model is not the model this step was "
                             "built for")
        mark.begin()
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
                                     feats_old, data_group)
        mark("losses")
        params = {n: p for n, p in model.named_parameters()
                  if p.requires_grad}
        for p in params.values():
            p.grad = None
        terms["loss_tot"].backward()
        in_group = mesh is not None or P.is_distributed()
        mark("backward", "all_reduce" if in_group else None)
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        # inside a process group: the global batch's gradient, before the
        # regularizer's accumulators read it (the JAX step's EWC/PI/RW see
        # the global gradient) and before nan_guard's finite test (every
        # process then decides alike; on a 2-D mesh the data group's ranks
        # from here, the model group's by the test's own reduction)
        if mesh is not None:
            # a shard's gradient over the ranks that hold that shard; a
            # replicated tensor's, the same on every model rank, over the
            # world, which leaves its bits equal across a model group
            P.all_reduce_mean_([g for n, g in grads.items()
                                if n in model.sharded], data_group)
            P.all_reduce_mean_([g for n, g in grads.items()
                                if n not in model.sharded])
            mark("all_reduce")
        elif in_group:
            P.all_reduce_mean_(list(grads.values()))
            mark("all_reduce")
        # the global batch's loss terms: every per-pixel mean divides by
        # all the pixels, as many on each process, so the mean of the
        # processes' means is the global mean (no normalization on the
        # train path counts valid pixels: BCE is "mean_all"); `l_con` is
        # already the global batch's on every process
        metrics = P.reduce_metrics(
            {k: v.detach() for k, v in terms.items()},
            [k for k in terms if k != "l_con"], data_group)
        metrics["l_reg"] = torch.zeros_like(metrics["loss_tot"])
        if state.reg_state is not None:
            # accumulators from the main loss's gradients, then the
            # penalty's analytic gradient, before the mask
            R.update(state.reg_state, grads, params)
            l_reg, pgrad = R.penalty_and_grad(state.reg_state, params,
                                              cfg.reg_importance)
            if l_reg is not None:
                metrics["l_reg"] = l_reg.to(metrics["loss_tot"].dtype)
                grads = dict(zip(grads, torch._foreach_add(
                    list(grads.values()), [pgrad[n] for n in grads])))
        tx.update({n: params[n] for n in params if mask[n]},
                  {n: grads[n] for n in params if mask[n]},
                  state.opt_state)
        mark("optimizer")
        metrics["lr"] = tx.sched(state.step, metrics["loss_tot"].dtype)
        state.step.add_(1)
        return metrics

    return core


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
    "losses", "backward", inside a process group "all_reduce", then
    "optimizer"), for a caller that times the parts. The step's own mark
    (`fn.phases`, a `tracing.PhaseMark`) calls it and, with tracing on
    (utils/tracing.py), spans each part and records a timing event after
    it.

    Inside a process group (ucd_torch/parallel) `batch` is this process's
    shard of the global batch, and the step computes what the one-process
    step computes on the global batch, up to reduction order: train-mode
    BatchNorm statistics, the contrastive term, the gradient and the loss
    metrics are the global batch's, and every process applies the same
    update. On a 2-D mesh (`model` sharded by `build_train_state(...,
    mesh=...)`) `batch` is the shard of the rank's data group
    (`shard_batch(batch, mesh.data_index, mesh.n_data)`), every rank
    applies the update of its own shards, and the donor shell `model_old`
    is put on the mesh too, its own tensors freed (the meta device)."""
    dev = _step_device(device, model, model_old)
    mark = tracing.PhaseMark(mark, cuda=dev.type == "cuda")
    core = _make_core(cfg, model, model_old, total_iters, step_idx)

    def train_step(state: TrainState, batch, old_vars=None):
        mark("start")
        x, labels = _batch(batch, dev)
        mark("upload")
        return state, core(state, x, labels, old_vars, mark)

    train_step.phases = mark
    return train_step


# the kernels' launch counters (function, attribute): a replay of a
# captured step launches without calling the wrappers, so the bundle adds
# what the capture counted once per replay
def _launch_counters():
    return [(fn, name) for fn in (FL.fused_ce_kd, FE.fused_argmax,
                                  TT.pixel_contrastive_loss_tiled)
            for name in sorted(vars(fn)) if name.startswith("launches")]


def _read_counters() -> list:
    return [getattr(fn, name) for fn, name in _launch_counters()]


def _add_counters(delta) -> None:
    for (fn, name), d in zip(_launch_counters(), delta):
        setattr(fn, name, getattr(fn, name) + d)


def _state_tensors(state: TrainState, old_vars) -> list:
    """Every tensor a captured step reads or writes besides its inputs."""
    opt = state.opt_state
    return [*state.model.parameters(), *state.model.buffers(),
            *opt["trace"].values(), opt["count"], opt["nonfinite"],
            state.step, *R.state_tensors(state.reg_state),
            *(old_vars.values() if old_vars is not None else ())]


def _stack_rows(rows) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


class _Capture:
    """One train step captured in a CUDA graph over static input buffers,
    with the launches the capture counted, the state it is bound to and
    its phase mark (`phases`: the events every replay records, if tracing
    was on at the capture)."""

    def __init__(self, core, state, images, labels, old_vars, stream):
        self.image = torch.empty_like(images)
        self.label = torch.empty_like(labels)
        self.image.copy_(images)
        self.label.copy_(labels)
        self.bound = [t.data_ptr() for t in _state_tensors(state, old_vars)]
        self.graph = torch.cuda.CUDAGraph()
        self.phases = tracing.PhaseMark(cuda=True)
        before = _read_counters()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local"):
                self.out = core(state, self.image.permute(0, 3, 1, 2),
                                self.label, old_vars, self.phases)
        except Exception as e:
            raise RuntimeError(
                f"CUDA-graph capture of the train step failed: {e}") from e
        self.capture_s = time.perf_counter() - t0
        after = _read_counters()
        # the capture launched nothing: its counts move to the replays
        self.launches = [a - b for a, b in zip(after, before)]
        _add_counters([-d for d in self.launches])

    def replay(self, state, images, labels, old_vars) -> dict:
        if [t.data_ptr() for t in _state_tensors(state, old_vars)] \
                != self.bound:
            raise RuntimeError(
                "the train state or the donor's variables were rebound "
                "since the capture: update them in place (copy_) so the "
                "captured step reads them")
        with tracing.span("ucd.step.upload"):
            self.image.copy_(images)
            self.label.copy_(labels)
        self.graph.replay()
        _add_counters(self.launches)
        return {k: v.clone() for k, v in self.out.items()}


def make_train_bundle(cfg: Config, model, model_old, total_iters: int,
                      k: int, step_idx: Optional[int] = None, device=None):
    """K train steps per call, the same math as K calls of
    `make_train_step` (whose step it runs).

    Returns fn(state, batches, old_vars=None) -> (state, metrics) with
    batches = {'image': (K,B,H,W,3), 'label': (K,B,H,W)} and each metric
    stacked (K,), as the JAX package's `lax.scan` returns them. On CUDA the
    first call runs slot 0 as an eager step (it also warms up what the
    kernels upload once), then captures one step in a CUDA graph over
    static input buffers, and every later slot copies its batch into them
    and replays the graph: one host dispatch per step instead of some
    thousands. Inside a process group the graph holds the step's NCCL
    collectives (the communicator exists from `init_group` on, and slot
    0 has run each collective eagerly, on a 2-D mesh over each subgroup,
    whose communicator that run makes if `new_group` did not). A failed capture raises. The graph
    reads the state where it was at the capture, so state tensors must be
    updated in place (`load_state_dict`, `copy_`), never rebound: the
    bundle raises if they were. Eager steps between calls are fine. On the CPU it runs the step
    K times. `fn.capture` holds the capture (its `capture_s`, launches per
    replay, `phases`) once made; `fn.phases` is the mark of the steps it
    runs eagerly. With tracing on the bundle spans its upload of the K
    batches and each replay's staging copy as `ucd.step.upload`; the
    captured step's phases have events only if tracing was on at the
    capture (utils/tracing.py)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    dev = _step_device(device, model, model_old)
    return _Bundle(_make_core(cfg, model, model_old, total_iters, step_idx),
                   dev, k)


class _Bundle:
    """`make_train_bundle`'s callable. An object, not a closure: a closure
    that names itself would keep its captured graph alive until a garbage
    collection, and a graph holding NCCL collectives must be gone before
    the process group is."""

    def __init__(self, core, dev, k):
        self.core, self.dev, self.k = core, dev, k
        self.capture = None
        self.phases = tracing.PhaseMark(cuda=dev.type == "cuda")

    def __call__(self, state: TrainState, batches, old_vars=None):
        core, dev, k, mark = self.core, self.dev, self.k, self.phases
        with tracing.span("ucd.step.upload"):
            images = torch.as_tensor(batches["image"]).to(dev)
            labels = torch.as_tensor(batches["label"]).to(dev)
        if images.shape[0] != k or labels.shape[0] != k:
            raise ValueError(f"expected {k} stacked batches, got "
                             f"{images.shape[0]} images, {labels.shape[0]} "
                             f"labels")
        rows, start = [], 0
        if dev.type != "cuda":
            for i in range(k):
                rows.append(core(state, images[i].permute(0, 3, 1, 2),
                                 labels[i], old_vars, mark))
            return state, _stack_rows(rows)
        cap = self.capture
        if cap is None:
            # slot 0 is a real step of the trajectory, run eagerly on the
            # stream the capture then uses
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                rows.append(core(state, images[0].permute(0, 3, 1, 2),
                                 labels[0], old_vars, mark))
            torch.cuda.current_stream(dev).wait_stream(stream)
            cap = self.capture = _Capture(
                core, state, images[0], labels[0], old_vars, stream)
            start = 1
        elif tuple(cap.image.shape) != tuple(images.shape[1:]) \
                or cap.image.dtype != images.dtype \
                or tuple(cap.label.shape) != tuple(labels.shape[1:]) \
                or cap.label.dtype != labels.dtype:
            raise ValueError(
                f"the bundle was captured for batches of "
                f"{tuple(cap.image.shape)} {cap.image.dtype} images and "
                f"{tuple(cap.label.shape)} {cap.label.dtype} labels")
        for i in range(start, k):
            rows.append(cap.replay(state, images[i], labels[i], old_vars))
        return state, _stack_rows(rows)


def make_eval_step(cfg: Config, model, model_old=None, device=None):
    """Validate step: criterion loss + distillation terms for logging,
    argmax prediction, confusion-matrix update. It runs on `device`: CUDA
    unless the caller passes one, and `model` must already be there.

    Returns fn(variables, batch, hist, old_vars=None) ->
    (hist, {"loss", "lkd", "lde"}, preds). `variables` is a state_dict to
    evaluate `model` on, or None for the model's own tensors. Inside a
    process group `batch` is this process's shard: the confusion counts
    and the losses are the global batch's (`preds` this process's).

    On a 2-D mesh, as the JAX step runs unchanged on channel-sharded
    variables, `variables` and `old_vars` are this rank's shards (the
    donor shell is put on the mesh, as in the train step), `batch` is the
    data group's shard, and the forward carries the model axis: every
    model rank of a data shard holds the whole low-res logits and computes
    the same `preds`, so the confusion counts and the losses are summed
    over the data group only, each pixel once."""
    _check_cfg(cfg)
    dev = _step_device(device, model, model_old)
    has_old = model_old is not None
    n_classes = cfg.tot_classes
    mesh = getattr(model, "mesh", None)
    data_group = None
    if mesh is not None:
        data_group = mesh.data_group
        if has_old:
            use_mesh(model_old, mesh)
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
        ce_mode, kd_mode, use_fused = _fused_gate(
            cfg, sem.shape, labels.shape,
            feats_old["sem"].shape if kd_on else None, sem.device)
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
            outputs_old = _dense_outputs(cfg, feats_old["sem"], hw) \
                if use_old and (kd_on or cfg.icarl) else None
            # iCaRL's disjoint criterion needs the donor's logits: without
            # its variables the step takes the BCE criterion
            icarl_only_dist = cfg.icarl and cfg.icarl_disjoint and use_old
            loss = _dense_criterion(cfg, outputs, labels, outputs_old,
                                    icarl_only_dist)
            if kd_on:
                lkd = _dense_kd(cfg, outputs, outputs_old)  # logging only
            preds = outputs.argmax(dim=-1).to(torch.int32)

        # inside a process group, the global batch's counts and losses
        hist = confusion_matrix_update(hist, labels, preds, n_classes,
                                       all_ranks=P.is_distributed(),
                                       group=data_group)
        losses = P.reduce_metrics({"loss": loss, "lkd": lkd, "lde": lde},
                                  ("loss", "lkd", "lde"), data_group)
        return hist, losses, preds

    return eval_step


__all__ = ["TrainState", "Optimizer", "make_lr_schedule",
           "make_optimizer", "compute_train_losses", "make_train_step",
           "make_train_bundle", "make_eval_step"]
