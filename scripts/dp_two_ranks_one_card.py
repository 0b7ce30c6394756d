#!/usr/bin/env python3
"""Two data-parallel ranks on ONE GPU: can the port's multi-process step
run with two processes sharing a card?

NCCL refuses two ranks on one device, so the trial uses gloo with CUDA
tensors (every collective staged through the host). The parent process
builds chip_smoke.py's full-width UCD train state (VOC 15-5s step 1,
ResNet-101, batch 8, 512x512, bf16 with f32 masters), saves it and takes
one plain step on the batch of 8; then two spawned ranks on cuda:0 load
the same state, join a gloo group, and each takes the step on its 4
images. Rank 0 measures how far the result is from the plain step
(`chip_smoke.dp_deviation`), holds the loss terms to phase 3f's bound
(`chip_smoke.DP_VS_PLAIN`) and times a few two-rank steps.

    python3 scripts/dp_two_ranks_one_card.py [--out FILE.json]

Prints one JSON line: "ok" with the comparison and timing, or the error
each rank raised. Exits 0 either way (the trial's outcome is the
result); exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
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


def _state(cs, dev):
    """chip_smoke's phase 3b start: (cfg, model, donor, state, donor
    variables)."""
    from ucd_torch import config as C
    cfg = C.make_config(**cs.TRAIN)
    step0 = cs.calibrated_model(dev, (16,), backbone=cfg.backbone, seed=5)
    prev_sd = {k: v.clone() for k, v in step0.state_dict().items()}
    del step0
    return (cfg, *cs.build_train(dev, cfg, prev_sd))


def rank_main(rank, rdzv, work, result):
    import chip_smoke as cs
    from ucd_torch import parallel as P
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.distributed.init_process_group("gloo", init_method=rdzv,
                                             world_size=2, rank=rank)
        saved = torch.load(os.path.join(work, "start.pt"),
                           weights_only=False)
        cfg, model, model_old, state, old_vars = _state(cs, dev)
        with torch.no_grad():
            model.load_state_dict(saved["model"])
            for k, v in old_vars.items():
                v.copy_(saved["old"][k])
        before = cs.snapshot(state, model)
        batch = P.shard_batch(saved["batch"])
        step = cs.make_train_step(cfg, model, model_old, total_iters=100)
        _, m = step(state, batch, old_vars)
        torch.cuda.synchronize()
        dist = ({k: float(v) for k, v in m.items()},
                cs.snapshot(state, model))
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch, old_vars)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if rank == 0:
            plain = torch.load(os.path.join(work, "plain.pt"))
            res = cs.dp_deviation(
                before, (plain["metrics"], plain["after"]), dist)
            res.update(ok=res["terms_rel_err"] <= cs.DP_VS_PLAIN[0],
                       step_s=times,
                       img_per_s=[cs.BATCH / t for t in times],
                       metrics_dist=dist[0], metrics_plain=plain["metrics"])
            with open(result, "w") as f:
                json.dump(res, f)
        P.shutdown()
    except BaseException:
        with open(f"{result}.rank{rank}", "w") as f:
            f.write(traceback.format_exc())
        raise


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the JSON result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dp_two_ranks_one_card: CUDA is not available",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ucd_torch.ops import build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(build.kernel_sources())
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as work:
        cfg, model, model_old, state, old_vars = _state(cs, dev)
        batch = cs.train_batches(1, cs.BATCH, cs.SIZE, cfg.tot_classes,
                                 seed=130)[0]
        torch.save({"model": model.state_dict(), "old": old_vars,
                    "batch": batch}, os.path.join(work, "start.pt"))
        step = cs.make_train_step(cfg, model, model_old, total_iters=100)
        _, m = step(state, batch, old_vars)
        torch.save({"metrics": {k: float(v) for k, v in m.items()},
                    "after": cs.snapshot(state, model)},
                   os.path.join(work, "plain.pt"))
        del model, model_old, state, old_vars, step
        torch.cuda.empty_cache()
        result = os.path.join(work, "result.json")
        try:
            mp.spawn(rank_main, args=(f"file://{work}/rendezvous", work,
                                      result), nprocs=2, join=True)
            with open(result) as f:
                out = json.load(f)
        except Exception as e:
            errors = {}
            for r in (0, 1):
                path = f"{result}.rank{r}"
                if os.path.exists(path):
                    with open(path) as f:
                        errors[f"rank{r}"] = f.read()[-3000:]
            out = {"ok": False, "error": f"{type(e).__name__}: {e}"[:2000],
                   "rank_errors": errors}
    out["card"] = cs.card()
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
