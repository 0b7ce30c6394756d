"""Command-line interface of the port: `predict` and `serve` over an
inference npz exported by either package.

    python -m ucd_torch.cli predict --model m.npz --images photos/ --out preds/
    python -m ucd_torch.cli serve --model m.npz --port 8433 --warmup_size 512

Both run on CUDA unless `--device cpu` is given. The train/test/run-task/
export subcommands come with later slices.
"""

from __future__ import annotations

import argparse
import sys

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ucd_torch")
    sub = p.add_subparsers(dest="command", required=True)
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
    for sp in (pr, sv):
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the "
                             "plain PyTorch versions of the kernels)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    # true f32 where the model computes in f32: cuDNN convolutions default
    # to TF32 (~3 decimal digits), which the JAX reference never uses
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    scales = tuple(float(s) for s in args.test_scales.split(","))

    if args.command == "predict":
        from .engine.export import (collect_images, load_inference,
                                    predict_paths)
        model, meta = load_inference(args.model, device=args.device)
        written = predict_paths(
            model, collect_images(args.images), args.out,
            dataset=meta["dataset"], bucket=args.bucket,
            batch_size=args.batch_size, fusion_mode=args.fusion_mode,
            scales=scales, flip=args.test_flip, save_ids=args.save_ids,
            fused=not args.no_fused, io_workers=args.io_workers,
            device=args.device)
        print(f"wrote {len(written)} files to {args.out}")
        return 0

    from .engine.server import serve
    serve(args.model, host=args.host, port=args.port,
          batch_size=args.batch_size, bucket=args.bucket,
          max_wait_ms=args.max_wait_ms, warmup_size=args.warmup_size,
          pipeline_depth=args.pipeline_depth, fusion_mode=args.fusion_mode,
          scales=scales, flip=args.test_flip, fused=not args.no_fused,
          verbose=args.verbose, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
