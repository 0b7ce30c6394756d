"""The rank side of the port's 2-D data x model mesh tests
(tests/test_torch_mesh2d*.py): gloo ranks spawned by
tests/torch_dp_workers.py's `run_ranks`, each a rank of a
`make_mesh_2d(n_data, n_model)` mesh. Imports torch and the port only."""

import dataclasses

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


def build(spec, mesh=None, min_size=64):
    """The port's model, donor, state and step from `spec` (`before`, the
    starting variables; `flat0`, the previous step's, or None at step 0),
    as `torch_dp_workers.build_port` builds them; on `mesh`, the full state
    is then sharded (`shard_train_state`) and the step built on it.
    Returns (cfg, model, state, donor variables, step fn)."""
    from ucd_torch.engine.state import build_train_state, shard_train_state
    from ucd_torch.engine.train import make_train_step
    from ucd_torch.models import (flax_to_state_dict, load_flax_variables,
                                  make_model)

    cfg = mesh_config(spec["method"], spec["step"], **spec["kw"])
    model = make_model(cfg)
    # every variable is loaded from `before` below
    model.init_weights = lambda generator: None
    prev = spec.get("flat0")
    model_old = None if prev is None \
        else make_model(cfg, cfg.classes_per_step[:-1])
    state, old = build_train_state(
        cfg, model, torch.Generator().manual_seed(1), W.TOTAL_ITERS,
        prev_model_state=None if prev is None else flax_to_state_dict(prev),
        device="cpu")
    load_flax_variables(model, spec["before"])
    if mesh is not None:
        state, old = shard_train_state(state, old, mesh, min_size)
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


def proof_worker(rank, out, n_data, n_model, min_size):
    """`build_train_state(..., mesh=...)` at float32 from a seeded init,
    then one UCD step under the collectives' tally: saves this rank's
    shards as built, its bytes of parameters + momentum + donor, the
    tally and the step's metrics; then the mesh's refusals. The bytes
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
    torch.save({"built": built, "bytes": nbytes, "tally": dict(counts),
                "metrics": {k: float(v) for k, v in m.items()},
                "place": (mesh.data_index, mesh.model_index),
                "refusals": refusals(mesh)}, f"{out}/proof{rank}.pt")


def refusals(mesh) -> list:
    """(what, message) for each refusal of the 2-D mesh: a mesh of another
    size than the world, and what it does not run yet."""
    from ucd_torch.engine.state import shard_train_state
    from ucd_torch.engine.train import (TrainState, make_eval_step,
                                        make_train_step)
    from ucd_torch.models import make_model
    from ucd_torch.models.layers import use_mesh

    caught = []

    def expect(what, fn, error=NotImplementedError):
        try:
            fn()
        except error as e:
            caught.append((what, str(e)))

    expect("size", lambda: P.make_mesh_2d(3, 2), ValueError)
    for option in ("remat", "remat_early", "stem_s2d", "bf16_norm",
                   "bf16_norm_early"):
        cfg = mesh_config("FT", 0, dtype="bfloat16", **{option: True})
        expect(option, lambda: use_mesh(make_model(cfg), mesh))
    gn = make_model(mesh_config("FT", 0, dtype="float32"))
    gn.body.mod1_bn1.norm_type = "gn"
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
    expect("regularizer", lambda: shard_train_state(
        TrainState(model, {"trace": {}}, reg_state=object()), None, mesh))
    return caught
