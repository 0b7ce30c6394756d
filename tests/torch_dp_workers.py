"""The rank side of the port's data-parallel tests (tests/test_torch_dp_*.py,
tests/test_torch_parallel.py): gloo process groups of CPU processes,
spawned with torch.multiprocessing over a `file://` rendezvous under the
test's tmp_path (no ports to race for), one torch thread a rank.

This module imports torch and the port only, so a spawned rank starts
without JAX; the tests compare what the ranks save with the JAX package in
the parent process."""

import dataclasses
import os

import numpy as np
import torch
import torch.multiprocessing as mp

from ucd_torch import config as TC
from ucd_torch import parallel as P

SIZE, TOTAL_ITERS = 64, 10
TERMS = ("loss", "lkd", "lde", "l_con", "l_icarl", "l_reg", "loss_tot")
REG_FIELDS = ("fisher", "delta", "score", "prev_params", "penalty_w",
              "old_params", "saved_score")


def as_tensors(tree):
    """numpy arrays of a nested dict/list -> torch tensors: `torch.save`
    writes tensors as raw storage, pickled numpy arrays take seconds."""
    if isinstance(tree, dict):
        return {k: as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_tensors(v) for v in tree)
    return torch.from_numpy(np.array(tree)) if isinstance(tree, np.ndarray) \
        else tree


def as_arrays(tree):
    """The inverse of `as_tensors`."""
    if isinstance(tree, dict):
        return {k: as_arrays(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_arrays(v) for v in tree)
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def _entry(rank, world, rdzv, fn, args):
    torch.set_num_threads(1)
    assert P.maybe_initialize(coordinator=rdzv, num_processes=world,
                              process_id=rank, device="cpu")
    try:
        fn(rank, *args)
    finally:
        P.shutdown()


def start_ranks(fn, world, tmp_path, *args):
    """Start fn(rank, *args) in `world` spawned processes joined in a gloo
    group, and return at once: the processes' context, whose `join()`
    returns True once all have ended and raises if any of them failed."""
    rdzv = f"file://{tmp_path}/rdzv_{fn.__name__}"
    prev = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        return mp.spawn(_entry, args=(world, rdzv, fn, args), nprocs=world,
                        join=False)
    finally:
        if prev is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = prev


def run_ranks(fn, world, tmp_path, *args):
    """Run fn(rank, *args) in `world` spawned processes joined in a gloo
    group; raises if any of them fails."""
    ranks = start_ranks(fn, world, tmp_path, *args)
    while not ranks.join():
        pass


# ---------------------------------------------------------------------------
# collectives and the synchronized BatchNorm
# ---------------------------------------------------------------------------

def gather_worker(rank, out):
    """gather_rows of a rank-dependent f64 tensor against a weight shared
    by the ranks; its backward; a non-differentiable uint8 gather."""
    x = (torch.arange(24, dtype=torch.float64).reshape(2, 3, 4)
         + 100 * rank).requires_grad_(True)
    w = torch.linspace(-1, 1, 48, dtype=torch.float64).reshape(4, 3, 4)
    y = P.gather_rows(x)
    (y * w).sum().backward()
    lab = P.gather_rows(torch.full((1, 5), rank + 7, dtype=torch.uint8))
    torch.save({"y": y.detach(), "grad": x.grad, "lab": lab},
               f"{out}/gather{rank}.pt")


def batchnorm_worker(rank, spec_path, out):
    """Train-mode BatchNorm2d on this rank's slice of a global batch;
    saves the output, the gradients and the running statistics."""
    from ucd_torch.models.layers import BatchNorm2d

    spec = torch.load(spec_path)
    n = spec["x"].shape[0] // P.world_size()
    bn = BatchNorm2d(spec["x"].shape[1], eps=1e-5, momentum=0.1,
                     dtype=torch.float64)
    bn.load_state_dict(spec["state"])
    x = spec["x"][rank * n:(rank + 1) * n].clone().requires_grad_(True)
    y = bn(x)
    (y * spec["g"][rank * n:(rank + 1) * n]).sum().backward()
    torch.save({"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad,
                "db": bn.bias.grad, "state": bn.state_dict()},
               f"{out}/bn{rank}.pt")


def remat_worker(rank, out):
    """A ResNet-18 body's train-mode forward and backward on this rank's
    image, plain and with every block rematerialized, from one seeded f64
    init; saves both runs' gradients, BatchNorm state and the number of
    statistics gathers each made."""
    import ucd_torch.models.layers as L
    from ucd_torch.models.resnet import ResNet

    calls = []
    gather = L.all_gather_rows

    def counting(x):
        calls.append(1)
        return gather(x)

    L.all_gather_rows = counting
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 3, 32, 32))
    res = {}
    for remat in (False, True):
        torch.manual_seed(0)
        body = ResNet((2, 2, 2, 2), False, 16, dtype=torch.float64,
                      remat=remat).train()
        calls.clear()
        y = body(x[rank:rank + 1])
        (y * y).sum().backward()
        res[remat] = {"grads": {n: p.grad for n, p in
                                body.named_parameters()},
                      "state": {k: v.clone() for k, v in
                                body.state_dict().items()},
                      "gathers": len(calls)}
    torch.save(res, f"{out}/remat{rank}.pt")


def indivisible_worker(rank, out):
    """An indivisible global batch raises before any step."""
    caught = []
    for fn in (lambda: P.make_mesh_multiprocess(3),
               lambda: P.local_batch_size(5),
               lambda: P.shard_batch({"image": np.zeros((3, 2))})):
        try:
            fn()
        except ValueError as e:
            caught.append(str(e))
    mesh = P.make_mesh_multiprocess(4)
    shard = P.shard_batch({"image": np.arange(4)})["image"].tolist()
    torch.save({"caught": caught, "mesh": tuple(mesh), "shard": shard},
               f"{out}/indivisible{rank}.pt")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def port_config(method, **kw):
    """VOC 15-5s step 1 under `method` at float64 with ResNet-18, as
    tests/test_torch_train_step.py builds the port's side; `batch_size` is
    the global batch."""
    args = dict(dataset="voc", task="15-5s", crop_size=SIZE, batch_size=2,
                step=1, method=method, dtype="float64", **kw)
    return dataclasses.replace(TC.make_config(**args), backbone="resnet18")


def build_port(spec):
    """The port's step-1 model, donor and state from `spec` (the step-0
    tree `flat0`, the starting variables `before`, the regularizer export
    `saved`), as tests/test_torch_families.py's `run_composed` builds
    them. Returns (cfg, model, state, donor variables, step fn, bundle fn
    or None)."""
    from ucd_torch.engine.state import build_train_state
    from ucd_torch.engine.train import make_train_bundle, make_train_step
    from ucd_torch.models import (flax_to_state_dict, load_flax_variables,
                                  make_model)

    cfg = port_config(spec["method"], **spec["kw"])
    model = make_model(cfg)
    # every variable is loaded from `before` below: the seeded init (slow
    # at float64 on the CPU) would be overwritten
    model.init_weights = lambda generator: None
    model_old = make_model(cfg, cfg.classes_per_step[:-1])
    state, old = build_train_state(
        cfg, model, torch.Generator().manual_seed(1), TOTAL_ITERS,
        prev_model_state=flax_to_state_dict(spec["flat0"]),
        prev_reg_saved=spec["saved"], device="cpu")
    load_flax_variables(model, spec["before"])
    rs = state.reg_state
    if rs is not None:
        with torch.no_grad():
            for k, p in model.named_parameters():
                if rs.prev_params is not None:
                    rs.prev_params[k].copy_(p)
                if k not in old:
                    rs.old_params[k].copy_(p)
    step = make_train_step(cfg, model, model_old, TOTAL_ITERS, device="cpu")
    bundle = make_train_bundle(cfg, model, model_old, TOTAL_ITERS, k=2,
                               device="cpu") if spec.get("bundle") else None
    return cfg, model, state, old, step, bundle


def snapshot(model, state, metrics):
    """What the tests compare: the model's variables in flax naming (f64
    numpy), the float metrics and the regularizer's accumulators."""
    from ucd_torch.models import module_to_flax, state_dict_to_flax

    out = {"vars": {k: np.asarray(v, np.float64)
                    for k, v in module_to_flax(model).items()},
           "metrics": {k: float(v) for k, v in metrics.items()}}
    rs = state.reg_state
    if rs is not None:
        out["reg_count"] = int(rs.count)
        out["reg"] = {f: (None if getattr(rs, f) is None else
                          {k: np.asarray(v, np.float64) for k, v in
                           state_dict_to_flax(getattr(rs, f)).items()})
                      for f in REG_FIELDS}
    return out


def step_worker(rank, spec_path, out):
    """One train step of this rank's shard of the global batch (and, with
    `spec["bundle"]`, a 2-slot bundle against two eager steps from one
    start); saves `snapshot`s."""
    spec = as_arrays(torch.load(spec_path))
    cfg, model, state, old, step, bundle = build_port(spec)
    batches = [P.shard_batch(b) for b in spec["batches"]]
    res = {}
    if bundle is None:
        state, m = step(state, batches[0], old)
        res["step"] = snapshot(model, state, m)
    else:
        start = {k: v.clone() for k, v in model.state_dict().items()}
        opt0 = {k: v.clone() for k, v in state.opt_state["trace"].items()}
        rows = []
        for b in batches:
            state, m = step(state, b, old)
            rows.append({k: float(v) for k, v in m.items()})
        res["eager"] = snapshot(model, state, {})
        res["eager_rows"] = rows
        with torch.no_grad():
            model.load_state_dict(start)
            for k, v in opt0.items():
                state.opt_state["trace"][k].copy_(v)
            state.opt_state["count"].zero_()
            state.step.zero_()
        stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
        state, m = bundle(state, stacked, old)
        res["bundle"] = snapshot(model, state, {})
        res["bundle_rows"] = [{k: float(v[i]) for k, v in m.items()}
                              for i in range(len(batches))]
    torch.save(as_tensors(res), f"{out}/step{rank}.pt")
