"""Experiment configuration of the port.

The port's own copy of ucd_tpu/config.py (the port imports nothing of the
JAX package): the same typed dataclass with the same fields and defaults,
the `--method` preset expander `apply_method`, the bug-compatible preset and
`make_config`. Every field is kept so that presets and CLI flags mean the
same in both packages. The model's execution options (`stem_s2d`,
`remat`, `remat_early`, `bf16_norm`, `bf16_norm_early`) mean what they
mean in the JAX package (models/segmentation.py `make_model`), and
`data_axis` is accepted and ignored, as there (no code of either package
reads it). `xla_options` forwards compiler options to the JAX package's
TPU backend and has no counterpart: the port's train step raises on a
non-default value (`unsupported_fields`) instead of ignoring it.
`steps_per_call` is the port's too: K train steps a call through a CUDA
graph (engine/train.py `make_train_bundle`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from . import tasks as task_registry

# 'att' is accepted and expands to no preset (flags are passed manually)
METHODS = ("FT", "LWF", "LWF-MC", "ILT", "EWC", "RW", "PI", "MiB", "att",
           "UCD")

# per-dataset total class counts incl. background/void; city_domain uses the
# fixed 19 train-ids at every step (domain-incremental)
NUM_CLASSES = {"voc": 21, "ade": 151, "city": 20, "city_domain": 19}

# TPU-execution fields and the only value of each that the port implements
TPU_ONLY_DEFAULTS = {"xla_options": ""}


@dataclass
class Config:
    # dataset / task
    dataset: str = "voc"
    task: str = "19-1"
    step: int = 0
    overlap: bool = False
    masking: bool = True
    data_root: str = "data"
    cross_val: bool = False        # True: val = 80/20 random split of train

    # method
    method: Optional[str] = None

    # training
    epochs: int = 30
    batch_size: int = 24           # global batch
    crop_size: int = 512
    lr: float = 0.007
    momentum: float = 0.9
    weight_decay: float = 1e-4
    lr_policy: str = "poly"        # poly | step
    lr_power: float = 0.9
    lr_decay_step: int = 5000
    lr_decay_factor: float = 0.1
    random_seed: int = 42
    num_workers: int = 4
    fix_bn: bool = False
    freeze: bool = False           # freeze backbone body in incremental steps

    # model
    backbone: str = "resnet101"    # resnet50 | resnet101
    output_stride: int = 16
    pretrained: bool = True
    pretrained_path: Optional[str] = None
    norm_act: str = "iabn_sync"    # all choices map to BN + leaky_relu
    pooling: int = 32              # ASPP eval pooling size
    head_channels: int = 256

    # losses / methods
    bce: bool = False
    unce: bool = False
    unkd: bool = False
    alpha: float = 1.0             # KD soft-label hardening
    loss_kd: float = 0.0
    loss_de: float = 0.0
    contrastive: bool = False      # UCD pixel-contrastive distillation term
    temperature: float = 0.07
    contrastive_weight: float = 0.01
    contrastive_capacity: int = 0      # 0 = full B*h*w pixel set
    contrastive_bug_compatible: bool = False
    freeze_cls0_always: bool = False   # cls_0 frozen even at step 0
    bug_compatible: bool = False       # see apply_bug_compatible
    icarl: bool = False
    icarl_importance: float = 1.0
    icarl_disjoint: bool = False
    icarl_bkg: bool = False
    init_balanced: bool = False

    # regularizers
    regularizer: Optional[str] = None   # ewc | pi | rw
    reg_importance: float = 1.0
    reg_alpha: float = 0.9
    reg_normalize: bool = True
    reg_iterations: int = 10

    # execution
    dtype: str = "bfloat16"        # compute dtype: bfloat16 | float32
                                   # (float64 is a test-only dtype)
    param_dtype: str = "float32"   # master weights; f32 is the only one
    xla_options: str = ""          # TPU compiler options (JAX package only)
    bf16_upsample: bool = True     # dense path only: upsample logits in bf16
    bf16_norm: bool = False        # every ABN rounds its output to bf16
    bf16_norm_early: bool = False  # stem + mod2 ABNs in bf16 (bf16 policy)
    stable_norm: bool = False      # the port always computes the
                                   # cancellation-free BatchNorm variance
    remat_early: bool = False      # rematerialize the mod2 blocks
    steps_per_call: int = 1        # train steps a call (CUDA graph)
    data_axis: int = 0             # accepted and ignored, as in JAX
    remat: bool = False            # rematerialize every residual block
    stem_s2d: bool = False         # stem conv space-to-depth packed
    nan_guard: bool = False        # skip updates with non-finite grads
    # the contrastive term through the streaming CUDA kernels of
    # ops/tiled_contrastive.py (the name is the JAX package's, kept so that
    # one set of kwargs builds both Configs); False = the dense loss
    use_pallas_contrastive: bool = True
    device_normalize: bool = True  # ship raw uint8 RGB, normalize on device
    fused_loss: bool = True        # fused upsample+CE/KD kernel
                                   # (ops/fused_loss.py): the full-res loss
                                   # chain never materializes the upsampled
                                   # (B,H,W,C) logits. Applies to the ce/unce
                                   # criterion and kd/unkd terms; bce/icarl
                                   # configs use the dense path

    # eval / logging / ckpt
    crop_val: bool = True
    eval_bucket_multiple: int = 128
    val_on_trainset: bool = False
    val_interval: int = 1
    ckpt_interval: int = 1
    visualize: bool = True
    wandb: bool = False
    num_classes_override: Optional[int] = None
    fusion_mode: str = "mean"      # TTA fusion: mean|voting|max
    test_scales: tuple = (1.0,)
    test_flip: bool = False
    print_interval: int = 10
    logdir: str = "./logs"
    name: str = "Experiment"
    ckpt_dir: str = "checkpoints/step"
    async_ckpt: bool = False
    ckpt: Optional[str] = None     # resume path
    auto_resume: bool = False
    step_ckpt: Optional[str] = None  # previous-step checkpoint override
    test_only: bool = False
    sample_num: int = 0
    debug: bool = False

    # -- derived ----------------------------------------------------------
    @property
    def num_classes(self) -> int:
        if self.num_classes_override is not None:
            return self.num_classes_override
        return NUM_CLASSES[self.dataset]

    @property
    def classes_per_step(self) -> list[int]:
        if self.dataset == "city_domain":
            # classes are fixed; steps add domains, not classifier heads
            return [NUM_CLASSES[self.dataset]]
        return task_registry.get_per_task_classes(self.dataset, self.task,
                                                  self.step)

    @property
    def tot_classes(self) -> int:
        return sum(self.classes_per_step)

    @property
    def old_classes(self) -> int:
        cps = self.classes_per_step
        return sum(cps[:-1]) if len(cps) > 1 else 0

    @property
    def new_classes(self) -> int:
        return self.classes_per_step[-1]

    @property
    def task_name(self) -> str:
        return f"{self.task}-{self.dataset}"

    def ckpt_path(self, step: Optional[int] = None) -> str:
        step = self.step if step is None else step
        return f"{self.ckpt_dir}/{self.task_name}_{self.name}_{step}"

    def resolve_pretrained_path(self) -> str:
        """ImageNet backbone release file."""
        if self.pretrained_path is not None:
            return self.pretrained_path
        return f"pretrained/{self.backbone}_{self.norm_act}.pth.tar"

    def validate(self) -> "Config":
        assert self.dataset in NUM_CLASSES, f"unknown dataset {self.dataset}"
        assert self.output_stride in (8, 16)
        assert self.backbone in ("resnet50", "resnet101")
        assert self.lr_policy in ("poly", "step")
        assert self.fusion_mode in ("mean", "voting", "max")
        assert self.ckpt_interval >= 1
        assert self.steps_per_call >= 1
        assert self.method is None or self.method in METHODS
        assert self.regularizer in (None, "ewc", "pi", "rw")
        if self.contrastive and self.contrastive_bug_compatible \
                and self.use_pallas_contrastive:
            raise ValueError(
                "contrastive_bug_compatible requires the dense path: pass "
                "use_pallas_contrastive=False (--no_pallas). The tiled "
                "kernel cannot reproduce the reference's unstabilized "
                "negative sum.")
        task_dict = task_registry.get_task_dict(self.dataset, self.task)
        assert self.step in task_dict, (
            f"step {self.step} out of range for task {self.task} "
            f"(valid: 0..{max(task_dict)})")
        if self.dataset == "city_domain":
            assert not (self.unce or self.unkd or self.contrastive
                        or self.icarl or self.init_balanced), (
                "background-unbiased / contrastive / icarl methods require "
                "class-incremental steps; use FT/LWF/ILT/EWC/PI/RW for "
                "domain-incremental Cityscapes")
        return self


def unsupported_fields(cfg: Config) -> list[str]:
    """TPU-execution fields of `cfg` set to a value the port does not
    implement (the train and eval steps raise on a non-empty list)."""
    return [k for k, v in TPU_ONLY_DEFAULTS.items() if getattr(cfg, k) != v]


def apply_method(cfg: Config) -> Config:
    """Expand `cfg.method` into hyperparameters."""
    m = cfg.method
    if m is None or m == "FT":
        return cfg
    updates: dict = {}
    if m == "LWF":
        updates = dict(loss_kd=100.0)
    elif m == "LWF-MC":
        updates = dict(icarl=True, icarl_importance=10.0)
    elif m == "ILT":
        updates = dict(loss_kd=100.0, loss_de=100.0)
    elif m == "EWC":
        updates = dict(regularizer="ewc", reg_importance=500.0)
    elif m == "RW":
        updates = dict(regularizer="rw", reg_importance=100.0)
    elif m == "PI":
        updates = dict(regularizer="pi", reg_importance=500.0)
    elif m == "MiB":
        updates = dict(loss_kd=10.0, unce=True, unkd=True, init_balanced=True)
    elif m == "UCD":
        # MiB plus the pixel-contrastive term
        updates = dict(loss_kd=10.0, unce=True, unkd=True, init_balanced=True,
                       contrastive=True)
    return dataclasses.replace(cfg, **updates)


def apply_bug_compatible(cfg: Config) -> Config:
    """Expand `bug_compatible=True` into every as-shipped quirk of the
    original implementation that the defaults deliberately fix:

      * cls_0 frozen even at step 0;
      * the contrastive term runs for EVERY method at step > 0, not just UCD;
      * the contrastive loss uses the unstabilized-negative formula, which
        requires the dense path.
    """
    if not cfg.bug_compatible:
        return cfg
    updates: dict = dict(freeze_cls0_always=True,
                         contrastive_bug_compatible=True,
                         use_pallas_contrastive=False)
    if cfg.step > 0 and cfg.dataset != "city_domain":
        updates["contrastive"] = True
    return dataclasses.replace(cfg, **updates)


def make_config(**kwargs) -> Config:
    """Build, expand method preset + bug-compatible preset, validate."""
    cfg = Config(**kwargs)
    cfg = apply_method(cfg)
    cfg = apply_bug_compatible(cfg)
    return cfg.validate()


def poly_lr(base_lr: float, step: int, max_iters: int,
            power: float = 0.9) -> float:
    """PolyLR: base*(1-iter/max_iter)^power, stepped per iteration."""
    return base_lr * max(0.0, (1.0 - step / max_iters)) ** power
