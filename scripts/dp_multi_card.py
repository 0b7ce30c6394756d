#!/usr/bin/env python3
"""The data-parallel step on N cards (one NCCL rank a card) against the
one-process step on the global batch, and its throughput a card.

chip_smoke.py phase 3f runs the data-parallel path on one rank, where the
collectives carry identity values. This script runs it where they do not:

  1. correctness, at float32 (where the comparison can tell a fault from
     rounding; PERF.md §6): the parent process builds chip_smoke's
     full-width UCD start (VOC 15-5s step 1, ResNet-101, 512x512, a
     seeded BN-calibrated donor) and takes one plain step on a global
     batch of 8 on cuda:0, and the same step with cuDNN off (a
     rounding-only change); then N ranks each take the step on their
     8 / N images. Rank 0 holds the N-rank step to the plain one with
     chip_smoke's `check_dp_deviation` (phase 3b's bf16 bound or twice
     the rounding-only change) and every rank's parameters to rank 0's,
     bit for bit;
  2. throughput, at bfloat16 (the main path): img/s a card of the UCD step
     at 8 images a card, eager and captured (`make_train_bundle`, K 4),
     on N ranks, beside the plain step on one card measured by the parent
     (chip_smoke's `time_dp_side`).

    python3 scripts/dp_multi_card.py [--ranks 4] [--out FILE]
    python3 scripts/dp_multi_card.py --device cpu --size 64 \\
        --backbone resnet50 --no-timing          # gloo rehearsal

Prints one JSON line ("ok", the comparisons, the timings, or each rank's
error) and exits non-zero if a check failed. Needs N GPUs unless
--device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GLOBAL_BATCH = 8   # the correctness step's global batch


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _cfg(cs, args, dtype):
    from ucd_torch import config as C
    return dataclasses.replace(
        C.make_config(**dict(cs.TRAIN, crop_size=args.size)),
        backbone=args.backbone, dtype=dtype)


def _step(cs, cfg, model, model_old, state, old_vars, batch, dev):
    from ucd_torch.engine.train import make_train_step
    step = make_train_step(cfg, model, model_old, total_iters=100,
                           device=dev)
    _, m = step(state, batch, old_vars)
    _sync(dev)
    return ({k: float(v) for k, v in m.items()},
            {k: v.cpu() for k, v in cs.snapshot(state, model).items()})


def _rank_state(cs, cfg, start, dev):
    """The start saved by the parent, in this rank's model and state."""
    model, model_old, state, old_vars = cs.build_train(
        dev, cfg, {k: v.to(dev) for k, v in start["old"].items()})
    with torch.no_grad():
        model.load_state_dict(start["model"])
    return model, model_old, state, old_vars


def rank_main(rank, world, rdzv, work, args):
    import chip_smoke as cs
    from ucd_torch import parallel as P
    dev = torch.device(args.device)
    try:
        if dev.type == "cpu":
            torch.set_num_threads(1)
        P.init_group(rdzv, world, rank, device=dev)
        dev = P.process_device(dev)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        start = torch.load(os.path.join(work, "start.pt"), weights_only=False)
        cfg = _cfg(cs, args, "float32")
        model, model_old, state, old_vars = _rank_state(cs, cfg, start, dev)
        before = {k: v.cpu() for k, v in cs.snapshot(state, model).items()}
        dist = _step(cs, cfg, model, model_old, state, old_vars,
                     P.shard_batch(start["batch"]), dev)
        # every rank holds the same parameters after the step
        sums = torch.stack([v.double().sum() for k, v in dist[1].items()
                            if k.startswith("model.")]).to(dev)
        every = P.collectives.all_gather_rows(sums[None])
        same = bool((every == every[:1]).all())
        out = {}
        if rank == 0:
            ref = torch.load(os.path.join(work, "plain.pt"))
            dp = cs.dp_deviation(before, (ref["metrics"], ref["after"]), dist)
            rounding = cs.dp_deviation(before, (ref["metrics"],
                                                ref["after"]),
                                       (ref["alt_metrics"],
                                        ref["alt_after"]))
            out = {"vs_plain_f32": dp, "rounding_only_f32": rounding,
                   "ranks_equal": same}
            cs.check_dp_deviation(dp, rounding, f"f32, {world} ranks")
            assert same, "the ranks' parameters differ after the step"
        del model, model_old, state, old_vars
        if args.timing:
            cfg16 = _cfg(cs, args, "bfloat16")
            model, model_old, state, old_vars = _rank_state(cs, cfg16, start,
                                                            dev)
            tr = {"cfg": cfg16, "model": model, "model_old": model_old,
                  "state": state, "old_vars": old_vars}
            batches = cs.train_batches(cs.BUNDLE_STEPS, args.batch,
                                       args.size, cfg16.tot_classes,
                                       seed=130 + 1000 * rank)
            t = cs.time_dp_side(tr, batches, f"{world} ranks, rank {rank}")
            if rank == 0:
                out["timing_rank0"] = t
        if rank == 0:
            with open(os.path.join(work, "result.json"), "w") as f:
                json.dump(out, f)
            print(f"rank 0: {json.dumps(out)}", flush=True)
        t0 = time.time()
        P.barrier()
        print(f"rank {rank}: barrier {time.time() - t0:.2f} s", flush=True)
        P.shutdown()
        print(f"rank {rank}: left the group {time.time() - t0:.2f} s",
              flush=True)
    except BaseException:
        with open(os.path.join(work, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8,
                    help="images a card in the throughput part")
    ap.add_argument("--backbone", default="resnet101")
    ap.add_argument("--no-timing", dest="timing", action="store_false")
    ap.add_argument("--deadline", type=float, default=300.0,
                    help="seconds the ranks may take; then they are killed")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and torch.cuda.device_count() < args.ranks:
        print(f"dp_multi_card: {args.ranks} ranks need {args.ranks} GPUs, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ucd_torch import parallel as P
    assert GLOBAL_BATCH % args.ranks == 0
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cuda":
        from ucd_torch.ops import build
        build.build(build.kernel_sources())
        dev = torch.device("cuda", 0)
    out = {"ranks": args.ranks, "device": args.device}
    with tempfile.TemporaryDirectory() as work:
        cfg = _cfg(cs, args, "float32")
        step0 = cs.calibrated_model(dev, (16,), backbone=args.backbone,
                                    size=args.size, batch=GLOBAL_BATCH,
                                    seed=5)
        prev = {k: v.clone() for k, v in step0.state_dict().items()}
        del step0
        model, model_old, state, old_vars = cs.build_train(dev, cfg, prev)
        batch = cs.train_batches(1, GLOBAL_BATCH, args.size,
                                 cfg.tot_classes, seed=130)[0]
        torch.save({"model": {k: v.cpu() for k, v in
                              model.state_dict().items()},
                    "old": {k: v.cpu() for k, v in old_vars.items()},
                    "batch": batch}, os.path.join(work, "start.pt"))
        snap = cs.snapshot(state, model)
        metrics, after = _step(cs, cfg, model, model_old, state, old_vars,
                               batch, dev)
        cs.restore(state, model, snap)
        # the rounding-only change: cuDNN off on the card (oneDNN off on
        # the CPU)
        with torch.backends.cudnn.flags(enabled=False), \
                torch.backends.mkldnn.flags(enabled=False):
            alt_metrics, alt_after = _step(cs, cfg, model, model_old, state,
                                           old_vars, batch, dev)
        torch.save({"metrics": metrics, "after": after,
                    "alt_metrics": alt_metrics, "alt_after": alt_after},
                   os.path.join(work, "plain.pt"))
        del model, model_old, state, old_vars, snap
        if args.timing:
            cfg16 = _cfg(cs, args, "bfloat16")
            model, model_old, state, old_vars = cs.build_train(dev, cfg16,
                                                               prev)
            tr = {"cfg": cfg16, "model": model, "model_old": model_old,
                  "state": state, "old_vars": old_vars}
            batches = cs.train_batches(cs.BUNDLE_STEPS, args.batch,
                                       args.size, cfg16.tot_classes,
                                       seed=130)
            out["timing_one_card_plain"] = cs.time_dp_side(
                tr, batches, "one card, plain")
            del model, model_old, state, old_vars, tr
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        assert not P.is_distributed()
        ok = True
        try:
            ctx = mp.spawn(rank_main, args=(args.ranks,
                                            f"file://{work}/rendezvous",
                                            work, args),
                           nprocs=args.ranks, join=False)
            deadline = time.time() + args.deadline
            while not ctx.join(timeout=5):
                if time.time() > deadline:
                    # a rank that does not exit is killed: the result, if
                    # written, still counts, and the hang is reported
                    out["ranks_killed_at_deadline"] = [
                        p.pid for p in ctx.processes if p.is_alive()]
                    for p in ctx.processes:
                        if p.is_alive():
                            p.kill()
                    break
            with open(os.path.join(work, "result.json")) as f:
                out.update(json.load(f))
        except Exception as e:
            ok = False
            out["error"] = f"{type(e).__name__}: {e}"[-3000:]
            for r in range(args.ranks):
                path = os.path.join(work, f"error{r}.txt")
                if os.path.exists(path):
                    with open(path) as f:
                        out[f"rank{r}_error"] = f.read()[-3000:]
    out["ok"] = ok
    out["card"] = cs.card() if dev.type == "cuda" else "cpu"
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
