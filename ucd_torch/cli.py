"""Command-line interface of the port.

The port's counterpart of ucd_tpu/cli.py, with the same subcommands and the
same flags, plus `--device` on each:

  train      one incremental step
  test       eval-only on a checkpoint
  run-task   every step of an incremental task in one command, then the
             aggregate report
  export     pack a step checkpoint into a standalone inference npz
  predict    predictions over image files from an inference npz
  serve      HTTP inference server over an inference npz

    python -m ucd_torch.cli run-task --dataset voc --task 15-5 \
        --method UCD --synthetic 16 --no_pretrained
    python -m ucd_torch.cli export --ckpt checkpoints/step/15-5-voc_Experiment_1 \
        --task 15-5 --step 1 --out m.npz
    python -m ucd_torch.cli predict --model m.npz --images photos/ --out preds/
    python -m ucd_torch.cli serve --model m.npz --port 8433 --warmup_size 512

Everything runs on CUDA unless `--device cpu` is given. `--steps_per_call
K` trains K steps a call through a CUDA graph. `train`, `test`,
`run-task` and `export` run on N processes (one a GPU over NCCL, or CPU
processes over gloo under `--device cpu`) with --coordinator,
--num_processes and --process_id (or the UCD_TPU_COORDINATOR /
UCD_TPU_NUM_PROCESSES / UCD_TPU_PROCESS_ID environment), or under
torchrun with --distributed (ucd_torch/parallel/distributed.py);
`--batch_size` is then the global batch. `--remat` rematerializes every
residual block in the backward, as in the JAX package; `--xla_options`
(compiler options of the JAX package's TPU backend) is parsed and refused
by name when set.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from . import tasks as task_registry
from .config import Config, apply_bug_compatible, apply_method


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ucd_torch")
    sub = p.add_subparsers(dest="command", required=True)
    for name in ("train", "test", "run-task"):
        sp = sub.add_parser(name)
        _add_common(sp)
    ex = sub.add_parser("export", help="pack a step checkpoint into a "
                        "standalone inference npz (params+batch_stats only)")
    _add_common(ex)
    ex.add_argument("--out", required=True, metavar="FILE.npz")
    ex.add_argument("--export_dtype", choices=["bfloat16", "float32"],
                    default="bfloat16")
    pr = sub.add_parser("predict", help="run predictions over image files "
                        "using an exported inference npz")
    pr.add_argument("--model", required=True, metavar="FILE.npz")
    pr.add_argument("--images", required=True,
                    help="an image file or a directory of images")
    pr.add_argument("--out", required=True, help="output directory")
    pr.add_argument("--bucket", type=int, default=128,
                    help="pad images to multiples of this (few batch "
                         "shapes across mixed sizes)")
    pr.add_argument("--batch_size", type=int, default=8,
                    help="batch same-bucket images per device call")
    pr.add_argument("--fusion-mode", dest="fusion_mode", default="mean",
                    choices=["mean", "voting", "max"])
    pr.add_argument("--test_scales", type=str, default="1.0")
    pr.add_argument("--test_flip", action="store_true", default=False)
    pr.add_argument("--save_ids", action="store_true", default=False,
                    help="also write raw class-id maps")
    pr.add_argument("--no_fused", action="store_true", default=False)
    pr.add_argument("--io_workers", type=int, default=8,
                    help="host decode/encode thread pool size")
    sv = sub.add_parser("serve", help="HTTP inference server over an "
                        "exported npz (dynamic micro-batching: concurrent "
                        "requests coalesce into batched device calls)")
    sv.add_argument("--model", required=True, metavar="FILE.npz")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8433)
    sv.add_argument("--bucket", type=int, default=128)
    sv.add_argument("--batch_size", type=int, default=8,
                    help="max images per device call")
    sv.add_argument("--max_wait_ms", type=float, default=5.0,
                    help="how long a request waits for batch peers")
    sv.add_argument("--pipeline_depth", type=int, default=2,
                    help="batched device calls kept in flight while more "
                         "traffic is queued (0 = synchronous dispatch)")
    sv.add_argument("--warmup_size", type=int, default=0,
                    help=">0: run one full batch of this square size "
                         "before accepting traffic")
    sv.add_argument("--fusion-mode", dest="fusion_mode", default="mean",
                    choices=["mean", "voting", "max"])
    sv.add_argument("--test_scales", type=str, default="1.0")
    sv.add_argument("--test_flip", action="store_true", default=False)
    sv.add_argument("--no_fused", action="store_true", default=False)
    sv.add_argument("--verbose", action="store_true", default=False,
                    help="per-request access log on stderr")
    for sp in sub.choices.values():
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the "
                             "plain PyTorch versions of the kernels)")
    return p



def _add_common(p: argparse.ArgumentParser) -> None:
    f = dataclasses.fields(Config)
    defaults = {x.name: x.default for x in f}

    p.add_argument("--dataset",
                   choices=["voc", "ade", "city", "city_domain"],
                   default="voc")
    p.add_argument("--task", default="19-1",
                   choices=task_registry.get_task_list())
    p.add_argument("--step", type=int, default=0)
    # 'att' is accepted for drop-in compat with the reference's choices list
    # (argparser.py:67); like the reference, it expands to no preset.
    p.add_argument("--method", default=None,
                   choices=["FT", "LWF", "LWF-MC", "ILT", "EWC", "RW", "PI",
                            "MiB", "att", "UCD"])
    p.add_argument("--data_root", default="data")
    p.add_argument("--overlap", action="store_true", default=False)
    p.add_argument("--no_mask", action="store_true", default=False)
    p.add_argument("--cross_val", action="store_true", default=False)

    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=24)
    p.add_argument("--crop_size", type=int, default=512)
    p.add_argument("--lr", type=float, default=0.007)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--lr_policy", choices=["poly", "step"], default="poly")
    p.add_argument("--lr_power", type=float, default=0.9)
    p.add_argument("--lr_decay_step", type=int, default=5000)
    p.add_argument("--lr_decay_factor", type=float, default=0.1)
    p.add_argument("--random_seed", type=int, default=42)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--freeze", action="store_true", default=False)
    p.add_argument("--fix_bn", action="store_true", default=False)

    p.add_argument("--backbone", choices=["resnet50", "resnet101"],
                   default="resnet101")
    p.add_argument("--output_stride", type=int, choices=[8, 16], default=16)
    p.add_argument("--no_pretrained", action="store_true", default=False)
    p.add_argument("--pretrained_path", default=None)
    p.add_argument("--norm_act", default="iabn_sync",
                   choices=["iabn_sync", "iabn", "abn", "std"])
    p.add_argument("--pooling", type=int, default=32)
    p.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default=None,
                   help="compute dtype (default bfloat16; an explicit value "
                        "overrides --opt_level)")
    # apex AMP drop-in compat (reference argparser.py:199): O0 = pure
    # fp32, O1-O3 = mixed precision -> bf16. No loss scaling is needed in
    # bf16 (same exponent range as fp32).
    p.add_argument("--opt_level", choices=["O0", "O1", "O2", "O3"],
                   default=None,
                   help="apex opt_level compat: O0 -> float32, "
                        "O1/O2/O3 -> bfloat16")
    # torch.distributed.launch plumbing: accepted for drop-in script compat
    # and ignored
    p.add_argument("--local_rank", type=int, default=None,
                   help="accepted and ignored (torch.distributed.launch "
                        "compat)")
    p.add_argument("--MASTER_PORT", type=str, default=None,
                   help="accepted and ignored (reference run.py NCCL "
                        "rendezvous compat)")
    p.add_argument("--remat", action="store_true", default=False,
                   help="rematerialize every residual block in the "
                        "backward (less activation memory, more compute)")
    p.add_argument("--nan_guard", action="store_true", default=False)
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="train steps per call: K > 1 captures the step "
                        "in a CUDA graph and replays it K times a call")
    p.add_argument("--xla_options", type=str, default="",
                   help="JAX package only (compiler options of its "
                        "train/eval steps): refused")

    p.add_argument("--bce", action="store_true", default=False)
    p.add_argument("--unce", action="store_true", default=False)
    p.add_argument("--unkd", action="store_true", default=False)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--loss_kd", type=float, default=0.0)
    p.add_argument("--loss_de", type=float, default=0.0)
    p.add_argument("--contrastive", action="store_true", default=False)
    p.add_argument("--temperature", type=float, default=0.07)
    p.add_argument("--contrastive_capacity", type=int,
                   default=defaults["contrastive_capacity"])
    p.add_argument("--no_pallas", action="store_true", default=False)
    p.add_argument("--no_fused_loss", action="store_true", default=False,
                   help="disable the fused upsample+CE/KD kernel (dense "
                        "full-resolution loss path, reference semantics)")
    p.add_argument("--no_device_normalize", action="store_true",
                   default=False,
                   help="normalize images on the host (reference "
                        "ToTensor+Normalize) instead of shipping uint8 and "
                        "normalizing on device")
    p.add_argument("--bug_compatible", action="store_true", default=False,
                   help="reproduce ALL as-shipped reference quirks in one "
                        "switch: cls[0] frozen even at step 0, contrastive "
                        "for every method at step>0, and the shipped "
                        "unstabilized contrastive formula (implies "
                        "--no_pallas for the contrastive term)")
    p.add_argument("--icarl", action="store_true", default=False)
    p.add_argument("--icarl_importance", type=float, default=1.0)
    p.add_argument("--icarl_disjoint", action="store_true", default=False)
    p.add_argument("--icarl_bkg", action="store_true", default=False)
    p.add_argument("--init_balanced", action="store_true", default=False)

    p.add_argument("--regularizer", choices=["ewc", "pi", "rw"], default=None)
    p.add_argument("--reg_importance", type=float, default=1.0)
    p.add_argument("--reg_alpha", type=float, default=0.9)
    p.add_argument("--reg_no_normalize", action="store_true", default=False)
    p.add_argument("--reg_iterations", type=int, default=10)

    p.add_argument("--crop_val", action="store_false", default=True)
    p.add_argument("--val_on_trainset", action="store_true", default=False)
    p.add_argument("--val_interval", type=int, default=1)
    p.add_argument("--ckpt_interval", type=int, default=1)
    # reference spelling: passing --visualize DISABLES TB summaries
    # (store_false, default True — argparser.py:116)
    p.add_argument("--visualize", action="store_false", default=True)
    p.add_argument("--wandb", action="store_true", default=False,
                   help="mirror scalar logs to wandb (reference run.py:25-30)")
    p.add_argument("--num_classes", type=int, default=None,
                   help="override the dataset's class count "
                        "(reference argparser.py:61)")
    p.add_argument("--fusion-mode", "--fusion_mode", dest="fusion_mode",
                   choices=["mean", "voting", "max"], default="mean")
    p.add_argument("--tta", action="store_true", default=False,
                   help="test-time augmentation: eval via the Predictor "
                        "with --fusion-mode/--test_scales/--test_flip")
    p.add_argument("--test_scales", default="1.0",
                   help="comma-separated TTA scale pyramid, e.g. "
                        "'0.75,1.0,1.25'")
    p.add_argument("--test_flip", action="store_true", default=False)
    p.add_argument("--print_interval", type=int, default=10)
    p.add_argument("--logdir", default="./logs")
    p.add_argument("--name", default="Experiment")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--async_ckpt", action="store_true", default=False,
                   help="write checkpoints on a background thread (the "
                        "epoch loop never blocks on serialization/disk)")
    p.add_argument("--auto_resume", action="store_true", default=False,
                   help="resume from this step's own checkpoint if present "
                        "(unattended restart after preemption)")
    p.add_argument("--step_ckpt", default=None)
    p.add_argument("--ckpt_dir", default="checkpoints/step")
    p.add_argument("--test", dest="test_only", action="store_true",
                   default=False)
    p.add_argument("--sample_num", type=int, default=0)
    p.add_argument("--debug", action="store_true", default=False)
    p.add_argument("--profile_dir", default=None)
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="use N random synthetic images instead of real data "
                        "(smoke-testing without datasets)")
    p.add_argument("--synthetic_learnable", type=int, default=0, metavar="N",
                   help="use N LEARNABLE color-coded synthetic images "
                        "(class->color + noise): exercises real retention/"
                        "forgetting dynamics across incremental steps "
                        "without the datasets")
    # multi-process launch (ucd_torch/parallel/distributed.py)
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rendezvous address of process 0 (or a "
                        "torch.distributed init URL, e.g. file:///path)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--distributed", action="store_true", default=False,
                   help="read the topology from torchrun's environment "
                        "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, "
                        "LOCAL_RANK)")


def config_from_args(args: argparse.Namespace) -> Config:
    dtype = args.dtype
    if dtype is None:
        dtype = "float32" if args.opt_level == "O0" else "bfloat16"
    cfg = Config(
        dataset=args.dataset, task=args.task, step=args.step,
        overlap=args.overlap, masking=not args.no_mask,
        data_root=args.data_root, cross_val=args.cross_val,
        method=args.method,
        epochs=args.epochs, batch_size=args.batch_size,
        crop_size=args.crop_size, lr=args.lr, momentum=args.momentum,
        weight_decay=args.weight_decay, lr_policy=args.lr_policy,
        lr_power=args.lr_power, lr_decay_step=args.lr_decay_step,
        lr_decay_factor=args.lr_decay_factor, random_seed=args.random_seed,
        num_workers=args.num_workers,
        fix_bn=args.fix_bn, freeze=args.freeze,
        backbone=args.backbone, output_stride=args.output_stride,
        pretrained=not args.no_pretrained,
        pretrained_path=args.pretrained_path, norm_act=args.norm_act,
        pooling=args.pooling, dtype=dtype, remat=args.remat,
        steps_per_call=args.steps_per_call,
        xla_options=args.xla_options,
        nan_guard=args.nan_guard,
        bce=args.bce, unce=args.unce, unkd=args.unkd, alpha=args.alpha,
        loss_kd=args.loss_kd, loss_de=args.loss_de,
        contrastive=args.contrastive, temperature=args.temperature,
        contrastive_capacity=args.contrastive_capacity,
        use_pallas_contrastive=not args.no_pallas,
        bug_compatible=args.bug_compatible,
        fused_loss=not args.no_fused_loss,
        device_normalize=not args.no_device_normalize,
        icarl=args.icarl, icarl_importance=args.icarl_importance,
        icarl_disjoint=args.icarl_disjoint, icarl_bkg=args.icarl_bkg,
        init_balanced=args.init_balanced,
        regularizer=args.regularizer, reg_importance=args.reg_importance,
        reg_alpha=args.reg_alpha, reg_normalize=not args.reg_no_normalize,
        reg_iterations=args.reg_iterations,
        crop_val=args.crop_val, val_on_trainset=args.val_on_trainset,
        val_interval=args.val_interval, ckpt_interval=args.ckpt_interval,
        visualize=args.visualize, wandb=args.wandb,
        num_classes_override=args.num_classes,
        fusion_mode=args.fusion_mode,
        test_scales=tuple(float(s) for s in args.test_scales.split(",")),
        test_flip=args.test_flip,
        print_interval=args.print_interval, logdir=args.logdir,
        name=args.name, ckpt=args.ckpt, async_ckpt=args.async_ckpt,
        auto_resume=args.auto_resume,
        step_ckpt=args.step_ckpt,
        ckpt_dir=args.ckpt_dir, test_only=args.test_only,
        sample_num=args.sample_num, debug=args.debug,
    )
    return apply_bug_compatible(apply_method(cfg)).validate()


def _make_bases(cfg: Config, n: int, learnable: int = 0):
    """Synthetic train/val bases for dataset-free smoke runs. `learnable`
    uses the color-coded task (class->color + noise) whose labels are
    predictable from pixels, so incremental retention/forgetting dynamics
    are real; the color mapping is shared across steps/splits."""
    if learnable > 0:
        from .data import LearnableSynthetic
        n_cls = cfg.num_classes  # full label space; remap handles future->bkg
        return (LearnableSynthetic(n=learnable, size=cfg.crop_size,
                                   n_classes=n_cls,
                                   seed=cfg.random_seed + cfg.step),
                LearnableSynthetic(n=max(learnable // 4, 4),
                                   size=cfg.crop_size, n_classes=n_cls,
                                   seed=cfg.random_seed + 1000))
    if n <= 0:
        return None, None
    from .data import SyntheticSegmentation
    # labels only from classes seen so far: keeps disjoint-mode filtering
    # (dataset/utils.py:19-42 semantics) from dropping every random image
    n_cls = cfg.tot_classes
    return (SyntheticSegmentation(n=n, size=cfg.crop_size, n_classes=n_cls,
                                  seed=cfg.random_seed + cfg.step),
            SyntheticSegmentation(n=max(n // 4, 4), size=cfg.crop_size,
                                  n_classes=n_cls,
                                  seed=cfg.random_seed + 1000))


def _run_one_step(cfg: Config, profile_dir=None, synthetic: int = 0,
                  tta: bool = False, learnable: int = 0, device="cuda"):
    from .engine.experiment import Experiment
    from .parallel import rank
    from .utils.reporting import write_step_csv

    base_train, base_val = _make_bases(cfg, synthetic, learnable)
    exp = Experiment(cfg, base_train=base_train, base_val=base_val,
                     device=device)
    try:
        exp.run(profile_dir=profile_dir)
        score = exp.predict_test() if tta else exp.final_test()
        if cfg.sample_num > 0:
            out = f"{cfg.logdir}/{cfg.task_name}/{cfg.name}/samples"
            n = exp.visualize(out, cfg.sample_num)
            print(f"wrote {n} visualization panels to {out}")
    finally:
        exp.close()
    if rank() == 0:
        csv_path = f"{cfg.logdir}/{cfg.task_name}/{cfg.name}/results.csv"
        write_step_csv(csv_path, cfg.step, score["Class IoU"])
        print(json.dumps({"step": cfg.step, "mean_iou": score["Mean IoU"]}))
    return score



# flags parsed for drop-in compatibility whose feature the port does not
# have: (flag, attribute, why); refused by name when set
_REFUSED = (("--xla_options", "xla_options", "the JAX package only"),)
_UNSET = {"xla_options": ""}


def refuse_unported(args: argparse.Namespace) -> None:
    """Raise SystemExit naming every set flag whose feature the port does
    not have."""
    bad = [f"{flag} ({item})" for flag, attr, item in _REFUSED
           if getattr(args, attr) != _UNSET[attr]]
    if bad:
        raise SystemExit("ucd_torch: not supported by the port: "
                         + ", ".join(bad))


def main(argv=None):
    args = build_parser().parse_args(argv)
    # true f32 where the model computes in f32: cuDNN convolutions default
    # to TF32 (~3 decimal digits), which the JAX reference never uses
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    if args.command == "predict":
        from .engine.export import (collect_images, load_inference,
                                    predict_paths)
        model, meta = load_inference(args.model, device=args.device)
        written = predict_paths(
            model, collect_images(args.images), args.out,
            dataset=meta["dataset"], bucket=args.bucket,
            batch_size=args.batch_size, fusion_mode=args.fusion_mode,
            scales=tuple(float(s) for s in args.test_scales.split(",")),
            flip=args.test_flip, save_ids=args.save_ids,
            fused=not args.no_fused, io_workers=args.io_workers,
            device=args.device)
        print(f"wrote {len(written)} files to {args.out}")
        return 0

    if args.command == "serve":
        from .engine.server import serve
        serve(args.model, host=args.host, port=args.port,
              batch_size=args.batch_size, bucket=args.bucket,
              max_wait_ms=args.max_wait_ms, warmup_size=args.warmup_size,
              pipeline_depth=args.pipeline_depth,
              fusion_mode=args.fusion_mode,
              scales=tuple(float(s) for s in args.test_scales.split(",")),
              flip=args.test_flip, fused=not args.no_fused,
              verbose=args.verbose, device=args.device)
        return 0

    refuse_unported(args)
    # before the first use of the device: joins the process group of a
    # multi-process launch, a no-op otherwise
    from .parallel import barrier, distributed, is_distributed
    joined = not is_distributed() and distributed.maybe_initialize(
        coordinator=args.coordinator, num_processes=args.num_processes,
        process_id=args.process_id, auto=args.distributed,
        device=args.device)
    if not joined:
        return _run(args)
    args.device = str(distributed.process_device(args.device))
    try:
        rc = _run(args)
        barrier()  # every process leaves the group together
        return rc
    finally:
        distributed.shutdown()


def _run(args: argparse.Namespace) -> int:
    from .parallel import barrier, rank
    cfg = config_from_args(args)

    if args.command == "export":
        from .engine.export import export_inference
        ckpt = cfg.ckpt or cfg.step_ckpt
        if ckpt is None:
            raise SystemExit(
                "export needs --ckpt (or --step_ckpt) naming the step "
                "checkpoint to pack")
        if rank() == 0:
            meta = export_inference(ckpt, args.out, cfg, args.export_dtype)
            print(f"exported {meta['path']}: {meta['backbone']} "
                  f"os{meta['output_stride']} classes={meta['classes']} "
                  f"dtype={meta['dtype']}")
        barrier()
        return 0

    if args.command == "train":
        _run_one_step(cfg, args.profile_dir, synthetic=args.synthetic,
                      tta=args.tta, learnable=args.synthetic_learnable,
                      device=args.device)
    elif args.command == "test":
        # --step_ckpt names the checkpoint UNDER EVALUATION here (in train
        # it is the previous step's): map it onto the same-step restore
        updates = {"test_only": True}
        if cfg.step_ckpt is not None and cfg.ckpt is None:
            updates["ckpt"] = cfg.step_ckpt
            updates["step_ckpt"] = None
        cfg = dataclasses.replace(cfg, **updates)
        _run_one_step(cfg, synthetic=args.synthetic, tta=args.tta,
                      learnable=args.synthetic_learnable, device=args.device)
    elif args.command == "run-task":
        # every step of the task in one process
        n_steps = task_registry.num_steps(cfg.dataset, cfg.task)
        for step in range(cfg.step, n_steps):
            step_cfg = dataclasses.replace(cfg, step=step).validate()
            _run_one_step(step_cfg, synthetic=args.synthetic,
                          learnable=args.synthetic_learnable,
                          device=args.device)
        if rank() != 0:
            return 0
        # the multi-step report
        from .utils.reporting import aggregate_csv, format_report
        csv_path = f"{cfg.logdir}/{cfg.task_name}/{cfg.name}/results.csv"
        first = len(task_registry.get_task_dict(cfg.dataset, cfg.task)[0]) - 1
        try:
            print(format_report(aggregate_csv(csv_path, first)))
        except (FileNotFoundError, IndexError):
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
