"""The rank side of the port's 2-D data x model mesh tests
(tests/test_torch_mesh2d*.py): gloo ranks spawned by
tests/torch_dp_workers.py's `run_ranks`, each a rank of a
`make_mesh_2d(n_data, n_model)` mesh. Imports torch and the port only."""

import dataclasses
import hashlib
import os
import time

import numpy as np
import torch

import torch_dp_workers as W
from ucd_torch import config as TC
from ucd_torch import parallel as P


def mesh_config(method, step, dtype="float64", **kw):
    """VOC 15-5s step `step` under `method` with ResNet-18 at 64x64, as
    tests/torch_dp_workers.py's `port_config`; global batch 2."""
    args = dict(dataset="voc", task="15-5s", crop_size=W.SIZE, batch_size=2,
                step=step, method=method, dtype=dtype, **kw)
    return dataclasses.replace(TC.make_config(**args), backbone="resnet18")


def group_norm_(model, groups):
    """Every ABN of `model` made a GroupNorm ABN of `groups` groups, in
    place: the JAX ABN's `norm_type="gn"` everywhere (the reference's
    convert_bn2gn)."""
    from ucd_torch.models.layers import ABN

    for name, m in list(model.named_modules()):
        if isinstance(m, ABN):
            owner, _, attr = name.rpartition(".")
            setattr(model.get_submodule(owner), attr, ABN(
                m.channels, m.activation, m.activation_param, dtype=m.dtype,
                norm_dtype=m.norm_dtype, norm_type="gn", gn_groups=groups))
    return model


def early_bf16_(model):
    """The stem's and mod2's ABNs round their output to bf16, in place:
    `bf16_norm_early`, which `make_model` applies under the bf16 policy
    only, on a model of any dtype."""
    from ucd_torch.models.layers import ABN

    for name, m in model.named_modules():
        if isinstance(m, ABN) and name.startswith(("body.mod1_",
                                                   "body.mod2_")):
            m.norm_dtype = torch.bfloat16
    return model


def build_parts(spec, mesh=None, min_size=64):
    """The port's model, donor shell and state from `spec` (`before`, the
    starting variables; `flat0`, the previous step's, or None at step 0;
    `saved`, a regularizer's export; `gn`, GroupNorm ABNs of that many
    groups; `early_bf16`), as `torch_dp_workers.build_port` builds them;
    on `mesh`, the full state is then sharded (`shard_train_state`).
    Returns (cfg, model, donor shell, state, donor variables)."""
    from ucd_torch.engine.state import build_train_state, shard_train_state
    from ucd_torch.models import (flax_to_state_dict, load_flax_variables,
                                  make_model)

    cfg = mesh_config(spec["method"], spec["step"], **spec["kw"])
    model = make_model(cfg)
    if spec.get("gn"):
        group_norm_(model, spec["gn"])
    if spec.get("early_bf16"):
        early_bf16_(model)
    # every variable is loaded from `before` below
    model.init_weights = lambda generator: None
    prev = spec.get("flat0")
    model_old = None if prev is None \
        else make_model(cfg, cfg.classes_per_step[:-1])
    state, old = build_train_state(
        cfg, model, torch.Generator().manual_seed(1), W.TOTAL_ITERS,
        prev_model_state=None if prev is None else flax_to_state_dict(prev),
        prev_reg_saved=spec.get("saved"), device="cpu")
    load_flax_variables(model, spec["before"])
    rs = state.reg_state
    if rs is not None:
        # the JAX state's anchors (tests/torch_dp_workers.py `build_port`)
        with torch.no_grad():
            for k, p in model.named_parameters():
                if rs.prev_params is not None:
                    rs.prev_params[k].copy_(p)
                if k not in old:
                    rs.old_params[k].copy_(p)
    if mesh is not None:
        state, old = shard_train_state(state, old, mesh, min_size)
    return cfg, model, model_old, state, old


def build(spec, mesh=None, min_size=64):
    """`build_parts` and the train step built on it: (cfg, model, state,
    donor variables, step fn)."""
    from ucd_torch.engine.train import make_train_step

    cfg, model, model_old, state, old = build_parts(spec, mesh, min_size)
    step = make_train_step(cfg, model, model_old, W.TOTAL_ITERS,
                           device="cpu")
    return cfg, model, state, old, step


def state_bytes(model, state, old) -> int:
    """Bytes of the parameters, the momentum and the donor's variables."""
    tensors = [*model.parameters(), *state.opt_state["trace"].values(),
               *(old.values() if old is not None else ())]
    return sum(t.numel() * t.element_size() for t in tensors)


def resident_bytes(module) -> int:
    """Bytes of `module`'s parameters and buffers that hold memory (not on
    the meta device)."""
    return sum(t.numel() * t.element_size()
               for t in [*module.parameters(), *module.buffers()]
               if t.device.type != "meta")


def step_worker(rank, spec_path, out, n_data, n_model, min_size):
    """One 2-D step of this rank's data shard; saves its state dict and
    momentum (shards), metrics and place on the mesh."""
    spec = W.as_arrays(torch.load(spec_path))
    mesh = P.make_mesh_2d(n_data, n_model)
    cfg, model, state, old, step = build(spec, mesh, min_size)
    batch = P.shard_batch(spec["batches"][0], mesh.data_index, mesh.n_data)
    state, m = step(state, batch, old)
    torch.save({"sd": {k: v.clone() for k, v in model.state_dict().items()},
                "trace": {k: v.clone() for k, v in
                          state.opt_state["trace"].items()},
                "sharded": sorted(model.sharded),
                "metrics": {k: float(v) for k, v in m.items()},
                "place": (mesh.data_index, mesh.model_index)},
               f"{out}/mesh{rank}.pt")


def digests(tensors) -> dict:
    """name -> a SHA-256 of the tensor's bytes (its values in NCHW order):
    equal digests, equal bits."""
    return {k: hashlib.sha256(
        v.detach().contiguous().view(-1).view(torch.uint8).numpy()
    ).hexdigest() for k, v in tensors.items()}


def _train_case(spec, mesh, min_size):
    """One train step of this rank's data shard of `spec["batches"][0]`
    on `mesh`; with `spec["nan"]` = (model rank, parameter), that rank's
    gradient of that (sharded) parameter is made NaN. Returns the digests
    of this rank's shards and momentum (and of its shards before, under
    `nan`), the optimizer's counts and the metrics; on data row 0 also the
    step's change of the shards and the regularizer's trees."""
    from ucd_torch.engine.train import make_train_step

    cfg, model, model_old, state, old = build_parts(spec, mesh, min_size)
    step = make_train_step(cfg, model, model_old, W.TOTAL_ITERS,
                           device="cpu")
    row0 = mesh.data_index == 0
    start = {k: v.clone() for k, v in model.state_dict().items()} \
        if row0 else None
    nan = spec.get("nan")
    before = digests(model.state_dict()) if nan is not None else None
    if nan is not None and mesh.model_index == nan[0]:
        dict(model.named_parameters())[nan[1]].register_hook(
            lambda g: torch.full_like(g, float("nan")))
    state, m = step(state, P.shard_batch(spec["batches"][0],
                                         mesh.data_index, mesh.n_data), old)
    rs = state.reg_state
    trace = state.opt_state["trace"]
    sd = model.state_dict()
    params = dict(model.named_parameters())
    return {"digests": {"sd": digests(sd), "trace": digests(trace)},
            "before": before,
            "trace_zero": all(not t.any() for t in trace.values()),
            # the step's change; a parameter's in f32 (half the bytes on
            # disk; its rounding, 6e-8 of the change, is far below the
            # updates' bounds), the statistics' in their dtype
            "delta": {k: (v - start[k]).to(
                torch.float32 if k in params else v.dtype)
                if v.is_floating_point() else v.clone()
                for k, v in sd.items()} if row0 else None,
            "count": int(state.opt_state["count"]),
            "nonfinite": int(state.opt_state["nonfinite"]),
            "sharded": sorted(model.sharded),
            "metrics": {k: float(v) for k, v in m.items()},
            "reg": None if rs is None or not row0 else dict(
                kind=rs.kind, count=int(rs.count),
                **{f: None if getattr(rs, f) is None else
                   {k: v.float() for k, v in getattr(rs, f).items()}
                   for f in W.REG_FIELDS}),
            "place": (mesh.data_index, mesh.model_index)}


def _eval_case(spec, mesh, min_size):
    """One validate step of this rank's data shard of `spec["batches"][0]`
    on `mesh`: the confusion matrix, the losses and the predictions."""
    from ucd_torch.engine.metrics import empty_confusion
    from ucd_torch.engine.train import make_eval_step

    cfg, model, model_old, state, old = build_parts(spec, mesh, min_size)
    step = make_eval_step(cfg, model, model_old, device="cpu")
    batch = P.shard_batch(spec["batches"][0], mesh.data_index, mesh.n_data)
    hist, losses, preds = step(None, batch,
                               empty_confusion(cfg.tot_classes, "cpu"), old)
    return {"hist": hist, "losses": {k: float(v) for k, v in losses.items()},
            "preds": preds, "place": (mesh.data_index, mesh.model_index)}


def cases_worker(rank, specs_path, out, n_data, n_model, min_size,
                 window=1, wait_s=1800.0):
    """Every case of `specs_path` in turn on one `make_mesh_2d(n_data,
    n_model)` mesh: {"vars": key -> flat variables, "cases": name -> spec}
    (`spec["eval"]` a validate step, else train steps), whose `before` and
    `flat0` name their variables and `saved` its trees. Saves this rank's
    result of case `name` as `{out}/{name}{rank}.pt` as soon as it has it
    (written whole, then renamed), and starts a case only once the reader
    has deleted this rank's file of the case `window` before it, so that
    at most `window` cases lie on disk (raises after `wait_s` seconds of
    waiting)."""
    specs = torch.load(specs_path, mmap=True)  # the ranks share the pages
    variables = W.as_arrays(specs["vars"])
    mesh = P.make_mesh_2d(n_data, n_model)
    names = list(specs["cases"])
    for i, name in enumerate(names):
        if i >= window:
            held = f"{out}/{names[i - window]}{rank}.pt"
            deadline = time.monotonic() + wait_s
            while os.path.exists(held):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{held} was not read")
                time.sleep(0.05)
        spec = W.as_arrays(specs["cases"][name])
        spec["before"] = variables[spec["before"]]
        spec["flat0"] = variables.get(spec["flat0"])
        if spec.get("saved"):
            spec["saved"] = {f: variables[k]
                             for f, k in spec["saved"].items()}
        res = (_eval_case if spec.get("eval") else _train_case)(
            spec, mesh, min_size)
        path = f"{out}/{name}{rank}.pt"
        torch.save(res, path + ".part")
        os.replace(path + ".part", path)


def proof_config():
    """The proof's step: UCD at VOC 15-5s step 1, ResNet-18 at 64x64,
    float32, global batch 2."""
    return mesh_config("UCD", 1, dtype="float32")


def proof_start(mesh=None, min_size=64):
    """`build_train_state` from a seeded init (the donor's too), on `mesh`
    or whole: (cfg, model, donor shell, state, donor variables)."""
    from ucd_torch.engine.state import build_train_state
    from ucd_torch.models import make_model

    cfg = proof_config()
    prev = make_model(cfg, cfg.classes_per_step[:-1]).init_weights(
        torch.Generator().manual_seed(3)).state_dict()
    model = make_model(cfg)
    model_old = make_model(cfg, cfg.classes_per_step[:-1])
    state, old = build_train_state(
        cfg, model, torch.Generator().manual_seed(4), W.TOTAL_ITERS,
        prev_model_state=prev, device="cpu", mesh=mesh, min_size=min_size)
    return cfg, model, model_old, state, old


def proof_batch(cfg):
    rs = np.random.RandomState(5)
    return {"image": rs.randint(0, 256, (2, W.SIZE, W.SIZE, 3)
                                ).astype(np.uint8),
            "label": rs.randint(0, cfg.tot_classes, (2, W.SIZE, W.SIZE)
                                ).astype(np.uint8)}


def reg_saved(cfg):
    """A seeded RW export (fisher and score) over the donor's parameters,
    as the previous step's `export_state` gives it."""
    from ucd_torch.models import make_model

    g = torch.Generator().manual_seed(7)
    names = dict(make_model(cfg, cfg.classes_per_step[:-1])
                 .named_parameters())
    return {f: {k: torch.rand(p.shape, generator=g) * 10.0 ** -i
                for i, (k, p) in enumerate(names.items())}
            for f in ("fisher", "score")}


def rw_state(mesh=None, min_size=64):
    """`build_train_state` under RW at VOC 15-5s step 1 (ResNet-18,
    float32) from seeded inits and `reg_saved`, on `mesh` or whole: its
    regularizer state."""
    from ucd_torch.engine.state import build_train_state
    from ucd_torch.models import make_model

    cfg = mesh_config("RW", 1, dtype="float32")
    prev = make_model(cfg, cfg.classes_per_step[:-1]).init_weights(
        torch.Generator().manual_seed(3)).state_dict()
    state, _ = build_train_state(
        cfg, make_model(cfg), torch.Generator().manual_seed(4),
        W.TOTAL_ITERS, prev_model_state=prev, prev_reg_saved=reg_saved(cfg),
        device="cpu", mesh=mesh, min_size=min_size)
    return state.reg_state


def proof_worker(rank, out, n_data, n_model, min_size):
    """`build_train_state(..., mesh=...)` at float32 from a seeded init,
    then one UCD step under the collectives' tally: saves this rank's
    shards as built, its bytes of parameters + momentum + donor, the
    tally and the step's metrics; then the RW state `build_train_state`
    makes on the mesh (`rw_state`) and the mesh's refusals. The bytes
    count what the donor shell still holds once the step is built."""
    from ucd_torch.engine.train import make_train_step

    mesh = P.make_mesh_2d(n_data, n_model)
    cfg, model, model_old, state, old = proof_start(mesh, min_size)
    built = {"sd": {k: v.clone() for k, v in model.state_dict().items()},
             "old": dict(old), "sharded": sorted(model.sharded)}
    step = make_train_step(cfg, model, model_old, W.TOTAL_ITERS,
                           device="cpu")
    # the donor shell too: functional_call reads the sharded variables
    nbytes = state_bytes(model, state, old) + resident_bytes(model_old)
    batch = P.shard_batch(proof_batch(cfg), mesh.data_index, mesh.n_data)
    with P.tally() as counts:
        state, m = step(state, batch, old)
    rs = rw_state(mesh, min_size)
    torch.save({"built": built, "bytes": nbytes, "tally": dict(counts),
                "metrics": {k: float(v) for k, v in m.items()},
                "place": (mesh.data_index, mesh.model_index),
                "reg": {"sharded": sorted(rs.sharded),
                        **{f: getattr(rs, f) for f in W.REG_FIELDS}},
                "refusals": refusals(mesh)}, f"{out}/proof{rank}.pt")


def eval_1x2_worker(rank, out):
    """The validate step on a 1 x 2 mesh (the proof's model, float32,
    both images on the one data shard): saves the confusion matrix, the
    losses and the predictions."""
    from ucd_torch.engine.metrics import empty_confusion
    from ucd_torch.engine.train import make_eval_step

    mesh = P.make_mesh_2d(1, 2)
    cfg, model, model_old, state, old = proof_start(mesh)
    step = make_eval_step(cfg, model, model_old, device="cpu")
    hist, losses, preds = step(None, proof_batch(cfg),
                               empty_confusion(cfg.tot_classes, "cpu"), old)
    torch.save({"hist": hist, "preds": preds,
                "losses": {k: float(v) for k, v in losses.items()}},
               f"{out}/eval{rank}.pt")


def refusals(mesh) -> list:
    """(what, outcome) for what the 2-D mesh refuses, a mesh of another
    size than the world (the error's message), and for each of what it
    once refused and now builds (None): GroupNorm ABN, the five execution
    options, nan_guard, the validate step and the regularizers."""
    from ucd_torch.engine.state import shard_train_state
    from ucd_torch.engine.train import (TrainState, make_eval_step,
                                        make_train_step)
    from ucd_torch.models import make_model
    from ucd_torch.models.layers import use_mesh
    from ucd_torch.ops import regularizers as R

    caught = []

    def expect(what, fn, error=NotImplementedError):
        try:
            fn()
        except error as e:
            caught.append((what, str(e)))
        else:
            caught.append((what, None))

    expect("size", lambda: P.make_mesh_2d(3, 2), ValueError)
    for option in ("remat", "remat_early", "stem_s2d", "bf16_norm",
                   "bf16_norm_early"):
        cfg = mesh_config("FT", 0, dtype="bfloat16", **{option: True})
        expect(option, lambda: use_mesh(make_model(cfg), mesh))
    gn = group_norm_(make_model(mesh_config("FT", 0, dtype="float32")), 16)
    expect("gn", lambda: use_mesh(gn, mesh))
    for what, kw in (("nan_guard", {"nan_guard": True}), ("validate", {})):
        cfg = mesh_config("FT", 0, dtype="float32", **kw)
        model = make_model(cfg)
        shard_train_state(TrainState(model, {"trace": {}}), None, mesh, 64)
        expect(what, (lambda: make_eval_step(cfg, model, device="cpu"))
               if what == "validate" else
               (lambda: make_train_step(cfg, model, None, 10,
                                        device="cpu")))
    model = make_model(mesh_config("FT", 0, dtype="float32"))
    rs = R.init_reg_state("ewc", dict(model.named_parameters()))
    expect("regularizer", lambda: shard_train_state(
        TrainState(model, {"trace": {}}, reg_state=rs), None, mesh, 64))
    return caught
