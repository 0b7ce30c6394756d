#!/usr/bin/env python3
"""The train step on a 2 x 2 data x model mesh of four cards (one NCCL
rank a card) against the one-process step on the global batch, and its
throughput, memory and collectives a card.

chip_smoke.py phase 3h runs the 1 x 2 mesh on one card over gloo. This
script runs the 2 x 2 mesh where the model axis rides NVLink, the ranks
ordered by `make_mesh_2d_hybrid(2)` (on one node: `make_mesh_2d(2, 2)`),
the wide convs' output channels sharded over each model pair (min_size
256):

  1. correctness, at float64 and float32: the parent process builds
     chip_smoke's full-width UCD start (VOC 15-5s step 1, ResNet-101,
     512x512, a seeded BN-calibrated donor) at float32 and its float64
     twin (`chip_smoke.f64_twin`, dense losses) and takes one plain step
     of each on a global batch of 8 on cuda:0, and the same step with
     cuDNN off (a rounding-only change); then the four ranks take each
     step, 4 images a data rank. The ranks' shards are put back together
     (`unshard_state`) and held to the plain step with chip_smoke's
     `check_dp_deviation`; replicated tensors must have the same bits on
     the ranks of a model pair, shards on the ranks of a data pair. The
     float64 comparison decides: there the mesh's arithmetic is the plain
     step's up to rounding far below any bound. The float32 one is
     reported beside it, with both f32 steps measured from the f64 plain
     step: on this batch one pooling-branch pre-activation lies within
     f32 rounding of the leaky ReLU's kink, and which side it falls on
     moves that BatchNorm's update by more than the bound (PERF.md §6);
  2. throughput, at bfloat16 (the main path): img/s a card of the UCD step
     at 8 images a data rank, eager and captured (`make_train_bundle`,
     K 4), chip_smoke's `time_dp_side` on each rank; each rank's bytes of
     parameters + momentum + donor against the one-card step's, peak
     memory, the step's collectives by group (`tally`) and the NCCL
     kernels' device time a step by kind (profiler).

    python3 scripts/mesh2d_multi_card.py [--out FILE]
    python3 scripts/mesh2d_multi_card.py --device cpu --size 64 \\
        --backbone resnet50 --batch 2 --min_size 64    # gloo rehearsal

Prints one JSON line ("ok", the comparisons, the timings, or each rank's
error) and exits non-zero if a check other than the float32 comparison
failed. Needs four GPUs unless --device cpu.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import traceback

import torch
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RANKS, N_MODEL = 4, 2
GLOBAL_BATCH = 8   # the correctness step's global batch
DTYPES = ("float64", "float32")   # the correctness steps


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _cfg(cs, args, dtype):
    from ucd_torch import config as C
    return dataclasses.replace(
        C.make_config(**dict(cs.TRAIN, crop_size=args.size)),
        backbone=args.backbone, dtype=dtype)


def _cpu(sd) -> dict:
    return {k: v.cpu() for k, v in sd.items()}


def _rank_state(cs, cfg, side, dev, mesh, min_size):
    """One start saved by the parent (`side`: its model's and donor's
    variables) in this rank's model and state, put on the mesh: (model,
    donor shell, state, donor variables)."""
    from ucd_torch.engine.state import shard_train_state
    model, model_old, state, old_vars = cs.build_train(
        dev, cfg, {k: v.to(dev) for k, v in side["old"].items()})
    with torch.no_grad():
        model.load_state_dict(side["model"])
    state, old_vars = shard_train_state(state, old_vars, mesh, min_size)
    return model, model_old, state, old_vars


def nccl_ms_by_kind(fn, n) -> dict:
    """The device ms a call of fn() spends in NCCL all-gather and
    all-reduce kernels (torch.profiler by kernel name, n calls)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {"all_gather_ms": 0.0, "all_reduce_ms": 0.0, "other_nccl_ms": 0.0,
           "nccl_kernels": 0}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or \
                "nccl" not in evt.key.lower():
            continue
        kind = "all_gather_ms" if "allgather" in evt.key.lower() else \
            "all_reduce_ms" if "allreduce" in evt.key.lower() else \
            "other_nccl_ms"
        out[kind] += evt.self_device_time_total / 1e3 / n
        out["nccl_kernels"] += evt.count / n
    return out


def rank_main(rank, rdzv, work, args):
    import chip_smoke as cs
    from ucd_torch import parallel as P
    from ucd_torch.engine.train import make_train_step
    dev = torch.device(args.device)
    try:
        if dev.type == "cpu":
            torch.set_num_threads(1)
        P.init_group(rdzv, RANKS, rank, device=dev)
        dev = P.process_device(dev)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = P.make_mesh_2d_hybrid(N_MODEL)
        start = torch.load(os.path.join(work, "start.pt"), weights_only=False)
        out = {"place": (mesh.data_index, mesh.model_index),
               "order": list(mesh.order)}
        batch = P.shard_batch(start["batch"], mesh.data_index, mesh.n_data)
        for dtype in DTYPES:
            cfg = start[dtype]["cfg"]
            model, model_old, state, old_vars = _rank_state(
                cs, cfg, start[dtype], dev, mesh, args.min_size)
            step = make_train_step(cfg, model, model_old, total_iters=100,
                                   device=dev)
            _, m = step(state, batch, old_vars)
            _sync(dev)
            out[dtype] = {"sharded": sorted(model.sharded),
                          "metrics": {k: float(v) for k, v in m.items()},
                          "after": _cpu(cs.snapshot(state, model))}
            del model, model_old, state, old_vars, step
        if args.timing:
            cfg16 = _cfg(cs, args, "bfloat16")
            model, model_old, state, old_vars = _rank_state(
                cs, cfg16, start["float32"], dev, mesh, args.min_size)
            tr = {"cfg": cfg16, "model": model, "model_old": model_old,
                  "state": state, "old_vars": old_vars}
            # the ranks of a model pair take the same data shard
            batches = cs.train_batches(cs.BUNDLE_STEPS, args.batch,
                                       args.size, cfg16.tot_classes,
                                       seed=130 + 1000 * mesh.data_index)
            # the step frees the donor shell's tensors (the meta device)
            step = make_train_step(cfg16, model, model_old, total_iters=100,
                                   device=dev)
            out["state_bytes"] = cs.state_bytes(state, model, old_vars,
                                                model_old)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            snap = cs.snapshot(state, model)
            with P.tally() as counts:
                step(state, batches[0], old_vars)
            _sync(dev)
            t = {"tally": {}}
            for (group, op, _), n in counts.items():
                key = f"{group}/{op}"
                t["tally"][key] = t["tally"].get(key, 0) + n
            if dev.type == "cuda":
                t["peak_gb_step"] = torch.cuda.max_memory_allocated() / 1e9
                t["nccl_by_kind"] = nccl_ms_by_kind(
                    lambda: step(state, batches[0], old_vars), 3)
                cs.restore(state, model, snap)
                # eager and captured img/s, device and NCCL time a step
                t.update(cs.time_dp_side(tr, batches,
                                         f"2 x 2 mesh, rank {rank}"))
                t["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            cs.restore(state, model, snap)
            out["timing"] = t
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        P.barrier()
        P.shutdown()
    except BaseException:
        with open(os.path.join(work, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def check_ranks(cs, ranks, dtype, ref, min_size):
    """The ranks' `dtype` step: the bits across ranks (raises if they
    differ where they must not), and the step put back together. Returns
    ({"vs_plain", "rounding_only", "sharded_tensors"}, (metrics, state
    after the step))."""
    by_place = {r["place"]: r[dtype] for r in ranks}
    assert sorted(by_place) == [(d, m) for d in range(RANKS // N_MODEL)
                                for m in range(N_MODEL)], sorted(by_place)
    first = by_place[(0, 0)]
    sharded = set(first["sharded"])
    for (d, m), r in by_place.items():
        assert set(r["sharded"]) == sharded
        assert r["metrics"] == first["metrics"], "metrics differ"
        for k, v in r["after"].items():
            other = by_place[(d, 0)] if k.split(".", 1)[-1] not in sharded \
                else by_place[(0, m)]
            assert torch.equal(v, other["after"][k]), (dtype, (d, m), k)
    after = cs.unshard_snapshot(
        [by_place[(0, m)]["after"] for m in range(N_MODEL)], ref["like"],
        min_size)
    mesh = (first["metrics"], after)
    plain = (ref["metrics"], ref["after"])
    return {"vs_plain": cs.dp_deviation(ref["before"], plain, mesh),
            "rounding_only": cs.dp_deviation(
                ref["before"], plain, (ref["alt_metrics"], ref["alt_after"])),
            "sharded_tensors": len(sharded)}, mesh


def plain_steps(cs, side, batch, dev) -> dict:
    """The plain step of `side` (cfg, model, donor, state, donor
    variables) on the whole batch, and the same with cuDNN off (oneDNN
    off on the CPU), each from the same start: {"before", "metrics",
    "after", "alt_metrics", "alt_after", "like"}. The plain step runs
    outside the flags, which would turn TF32 back on."""
    cfg, model, model_old, state, old_vars = side
    before = _cpu(cs.snapshot(state, model))
    ref = {"before": before, "like": _cpu(model.state_dict())}
    for cudnn, key in ((True, ""), (False, "alt_")):
        with contextlib.ExitStack() as off:
            if not cudnn:
                off.enter_context(torch.backends.cudnn.flags(enabled=False))
                off.enter_context(torch.backends.mkldnn.flags(enabled=False))
            step = cs.make_train_step(cfg, model, model_old, total_iters=100,
                                      device=dev)
            _, m = step(state, batch, old_vars)
            _sync(dev)
        ref[f"{key}metrics"] = {k: float(v) for k, v in m.items()}
        ref[f"{key}after"] = _cpu(cs.snapshot(state, model))
        cs.restore(state, model, {k: v.to(dev) for k, v in before.items()})
    return ref


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8,
                    help="images a data rank in the throughput part")
    ap.add_argument("--backbone", default="resnet101")
    ap.add_argument("--min_size", type=int, default=256)
    ap.add_argument("--no-timing", dest="timing", action="store_false")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and torch.cuda.device_count() < RANKS:
        print(f"mesh2d_multi_card: {RANKS} ranks need {RANKS} GPUs, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ucd_torch import parallel as P
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cuda":
        from ucd_torch.ops import build
        build.build(build.kernel_sources())
        dev = torch.device("cuda", 0)
    out = {"ranks": RANKS, "n_model": N_MODEL, "min_size": args.min_size,
           "device": args.device}
    ok = True
    with tempfile.TemporaryDirectory() as work:
        cfg = _cfg(cs, args, "float32")
        step0 = cs.calibrated_model(dev, (16,), backbone=args.backbone,
                                    size=args.size, batch=GLOBAL_BATCH,
                                    seed=5)
        prev = {k: v.clone() for k, v in step0.state_dict().items()}
        del step0
        batch = cs.train_batches(1, GLOBAL_BATCH, args.size,
                                 cfg.tot_classes, seed=130)[0]
        f32 = (cfg, *cs.build_train(dev, cfg, prev))
        sides = {"float32": f32, "float64": cs.f64_twin(f32, dev)}
        del f32
        start, refs = {"batch": batch}, {}
        for dtype in DTYPES:
            side = sides.pop(dtype)
            start[dtype] = {"cfg": side[0], "model": _cpu(
                side[1].state_dict()), "old": _cpu(side[4])}
            refs[dtype] = plain_steps(cs, side, batch, dev)
            del side
        torch.save(start, os.path.join(work, "start.pt"))
        del start
        if args.timing:
            cfg16 = _cfg(cs, args, "bfloat16")
            model, model_old, state, old_vars = cs.build_train(dev, cfg16,
                                                               prev)
            out["one_card_state_bytes"] = cs.state_bytes(state, model,
                                                         old_vars)
            del model, model_old, state, old_vars
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        assert not P.is_distributed()
        try:
            mp.spawn(rank_main, args=(f"file://{work}/rendezvous", work,
                                      args), nprocs=RANKS, join=True)
            ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                                weights_only=False) for r in range(RANKS)]
            got = {d: check_ranks(cs, ranks, d, refs[d], args.min_size)
                   for d in DTYPES}
            out["order"] = ranks[0]["order"]
            out["float64"], _ = got["float64"]
            out["float32"], mesh32 = got["float32"]
            # both f32 steps measured from the f64 plain step
            r32, r64 = refs["float32"], refs["float64"]
            truth = (r64["metrics"], r64["after"])
            out["float32"]["plain_vs_f64"] = cs.dp_deviation(
                r32["before"], truth, (r32["metrics"], r32["after"]))
            out["float32"]["mesh_vs_f64"] = cs.dp_deviation(
                r32["before"], truth, mesh32)
            try:
                cs.check_dp_deviation(out["float32"]["vs_plain"],
                                      out["float32"]["rounding_only"],
                                      "f32, 2 x 2 mesh")
                out["float32"]["check"] = "passed"
            except AssertionError as e:
                out["float32"]["check"] = f"failed: {e}"[:2000]
            cs.check_dp_deviation(out["float64"]["vs_plain"],
                                  out["float64"]["rounding_only"],
                                  "f64, 2 x 2 mesh")
            if args.timing:
                out["timing"] = {f"rank{r}": {
                    "place": x["place"], "state_bytes": x["state_bytes"],
                    **x["timing"]} for r, x in enumerate(ranks)}
        except Exception as e:
            ok = False
            out["error"] = f"{type(e).__name__}: {e}"[-3000:]
            for r in range(RANKS):
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
