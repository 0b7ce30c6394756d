#!/usr/bin/env python3
"""Two data-parallel ranks on ONE GPU: can the port's multi-process step
run with two processes sharing a card?

NCCL refuses two ranks on one device, so the trial uses gloo with CUDA
tensors (every collective staged through the host). The parent process
builds chip_smoke.py's full-width UCD train state (VOC 15-5s step 1,
ResNet-101, batch 8, 512x512, bf16 with f32 masters), saves it and takes
one plain step on the batch of 8 (and the same in its f32 twin,
`chip_smoke.f32_twin`, and that twin at float64, `chip_smoke.f64_twin`);
then two spawned ranks on cuda:0 load the same states, join a gloo
group, and each takes the step on its 4 images.
Rank 0 measures how far the result is from the plain step
(`chip_smoke.dp_deviation`), holds it there with phase 3f's
`check_dp_deviation` (the loss terms, the update overall and the worst
tensor's, each within `chip_smoke.DP_VS_PLAIN` or twice what the plain
step with cuDNN off, a rounding-only change, moves) and times a few
two-rank steps, at bf16, in the f32 twin and in its float64 twin (dense
losses, no kernel). The f32 plain and two-rank steps are also measured
from the float64 plain step: the two-rank step farther from it than the
plain one shows f32 rounding that the two ranks add, and the float64
comparison whether their arithmetic is the plain step's; the pooling
branch's BatchNorm outputs of the two steps are compared for elements
on the two sides of the leaky ReLU's kink. chip_smoke.py phase 3h runs
the same case at bf16 and f32.

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

DTYPES = ("bfloat16", "float32", "float64")


def _state(cs, dev):
    """chip_smoke's phase 3b start: (cfg, model, donor, state, donor
    variables)."""
    from ucd_torch import config as C
    cfg = C.make_config(**cs.TRAIN)
    step0 = cs.calibrated_model(dev, (16,), backbone=cfg.backbone, seed=5)
    prev_sd = {k: v.clone() for k, v in step0.state_dict().items()}
    del step0
    return (cfg, *cs.build_train(dev, cfg, prev_sd))


def record_pool_bn(model):
    """Record the next forward's output of the ASPP pooling branch's
    BatchNorm (its leaky ReLU's input): (list it lands in, hook handle)."""
    seen = []
    hook = model.head.global_pooling_bn.bn.register_forward_hook(
        lambda mod, args, y: seen.append(y.detach().clone()))
    return seen, hook


def sign_flips(got, want) -> dict:
    """Where `got` and `want` (the same pre-activations from two steps) lie
    on the two sides of the leaky ReLU's kink, and how far apart they are:
    a flip moves that element's gradient by 0.99 of itself."""
    want = want.to(got.device)
    flip = torch.sign(got) != torch.sign(want)
    return {"flips": int(flip.sum()), "want": want[flip].tolist()[:8],
            "got": got[flip].tolist()[:8],
            "max_abs_diff": float((got - want).abs().max()),
            "max_abs": float(want.abs().max())}


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
        batch = P.shard_batch(saved["batch"])
        out = {}
        for dtype in DTYPES:
            cfg = saved[dtype]["cfg"]
            model, model_old, state, old_vars = cs.build_train(
                dev, cfg, {k: v.to(dev) for k, v in
                           saved[dtype]["old"].items()})
            with torch.no_grad():
                model.load_state_dict(saved[dtype]["model"])
            before = cs.snapshot(state, model)
            step = cs.make_train_step(cfg, model, model_old, total_iters=100)
            seen, hook = record_pool_bn(model)
            _, m = step(state, batch, old_vars)
            hook.remove()
            torch.cuda.synchronize()
            dist = ({k: float(v) for k, v in m.items()},
                    cs.snapshot(state, model))
            flips = [None, None]
            torch.distributed.all_gather_object(flips, sign_flips(
                seen[0], torch.load(os.path.join(
                    work, f"plain_{dtype}.pt"))["pool_bn"][4 * rank:
                                                          4 * rank + 4]))
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(state, batch, old_vars)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            if rank == 0:
                plain = torch.load(os.path.join(work, f"plain_{dtype}.pt"))
                res = cs.dp_deviation(
                    before, (plain["metrics"], plain["after"]), dist)
                rounding = cs.dp_deviation(
                    before, (plain["metrics"], plain["after"]),
                    (plain["alt_metrics"], plain["alt_after"]))
                try:
                    cs.check_dp_deviation(res, rounding,
                                          f"two ranks, one card, {dtype}")
                    res["ok"] = True
                except AssertionError as e:
                    res.update(ok=False, why=str(e)[:1000])
                if dtype == "float32":
                    # the f32 steps against the same step at float64
                    f64 = torch.load(os.path.join(work, "plain_float64.pt"))
                    truth = (f64["metrics"], f64["after"])
                    res["plain_vs_f64"] = cs.dp_deviation(
                        before, truth, (plain["metrics"], plain["after"]))
                    res["two_ranks_vs_f64"] = cs.dp_deviation(before, truth,
                                                              dist)
                res["pool_bn_sign_flips"] = flips
                res.update(rounding_only=rounding, step_s=times,
                           img_per_s=[cs.BATCH / t for t in times],
                           metrics_dist=dist[0],
                           metrics_plain=plain["metrics"])
                out[dtype] = res
            del model, model_old, state, old_vars, step, before, dist
            torch.cuda.empty_cache()
        if rank == 0:
            out["ok"] = all(out[d]["ok"] for d in DTYPES)
            with open(result, "w") as f:
                json.dump(out, f)
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
        start = {"batch": batch}
        twin = cs.f32_twin({"cfg": cfg, "model": model,
                            "model_old": model_old, "state": state,
                            "old_vars": old_vars}, dev)
        sides = {"bfloat16": (cfg, model, model_old, state, old_vars),
                 "float32": twin, "float64": cs.f64_twin(twin, dev)}
        del twin
        for dtype in DTYPES:
            cfg, model, model_old, state, old_vars = sides.pop(dtype)
            start[dtype] = {"cfg": cfg, "model": model.state_dict(),
                            "old": old_vars}
            step = cs.make_train_step(cfg, model, model_old, total_iters=100)
            snap = cs.snapshot(state, model)
            seen, hook = record_pool_bn(model)
            _, m = step(state, batch, old_vars)
            hook.remove()
            plain = {"metrics": {k: float(v) for k, v in m.items()},
                     "after": cs.snapshot(state, model),
                     "pool_bn": seen[0].cpu()}
            cs.restore(state, model, snap)
            # a rounding-only change: the same step with cuDNN off
            with torch.backends.cudnn.flags(enabled=False):
                _, m = step(state, batch, old_vars)
            plain.update(alt_metrics={k: float(v) for k, v in m.items()},
                         alt_after=cs.snapshot(state, model))
            cs.restore(state, model, snap)
            torch.save(plain, os.path.join(work, f"plain_{dtype}.pt"))
            del snap, plain, step
        torch.save(start, os.path.join(work, "start.pt"))
        del model, model_old, state, old_vars, start
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
