"""The 2-D data x model mesh is real tensor parallelism: the port's
counterpart of tests/test_mesh2d_proof.py, on four gloo ranks as 2 x 2
(ResNet-18, 64x64, UCD at VOC 15-5s step 1, float32, `min_size` 64).

`build_train_state(..., mesh=...)` leaves each rank the shards
`shard_state` cuts from the full state. Over one train step, the
collectives' tally (ucd_torch/parallel/collectives.py `tally`) shows

  1. no all-gather whose result has a sharded parameter's full shape:
     parameters stay sharded through forward, backward, SGD and the
     donor (the "slower DP" failure the JAX test names);
  2. at least 20 collectives on the model groups (the JAX step on its
     4 x 2 mesh has 109);
  3. and each rank holds at most 0.65 of the 1-D rank's bytes of
     parameters + momentum + donor (JAX: 0.50), the donor shell's own
     tensors counted on the rank.

A regularizer's state that `build_train_state(..., mesh=...)` makes from
the shards is the whole-built state's shards, bit for bit (RW's penalty
weights normalized by each whole tensor's min and max). The mesh's one
refusal (a world of another size) is a named error, and what it once
refused (GroupNorm ABN, the five execution options, nan_guard, the
regularizers and the validate step) builds. On a 1 x 2 mesh the validate
step counts each pixel once.
"""

import functools

import numpy as np
import pytest
import torch

import torch_dp_workers as W
import torch_mesh2d_workers as M
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from ucd_torch import parallel as P
from ucd_torch.engine.metrics import empty_confusion
from ucd_torch.engine.state import shard_state
from ucd_torch.engine.train import make_eval_step

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_DATA, N_MODEL, MIN_SIZE = 2, 2, 64


@functools.lru_cache(maxsize=None)
def ranks(tmp):
    W.run_ranks(M.proof_worker, N_DATA * N_MODEL, tmp, str(tmp), N_DATA,
                N_MODEL, MIN_SIZE)
    return [torch.load(tmp / f"proof{r}.pt", weights_only=False)
            for r in range(N_DATA * N_MODEL)]


@pytest.fixture(scope="module")
def proof(tmp_path_factory):
    """Every rank's record, and the full state built alike without a
    mesh: (ranks, model, state, donor variables)."""
    got = ranks(tmp_path_factory.mktemp("proof"))
    _, model, _, state, old = M.proof_start()
    return got, model, state, old


def test_build_train_state_keeps_each_ranks_shard(proof):
    got, model, _, old = proof
    full = model.state_dict()
    sharding = P.channel_sharding(N_MODEL, full, MIN_SIZE)
    assert {r["place"] for r in got} == {(d, m) for d in range(N_DATA)
                                         for m in range(N_MODEL)}
    for r in got:
        _, m = r["place"]
        assert r["built"]["sharded"] == sorted(
            k for k, dim in sharding.items() if dim is not None)
        for what, want in (("sd", full), ("old", old)):
            mine = shard_state(want, N_MODEL, m, MIN_SIZE)
            assert set(mine) == set(r["built"][what])
            for k, v in mine.items():
                assert torch.equal(r["built"][what][k], v), (what, k)


def test_no_parameter_is_gathered_whole(proof):
    got, model, _, _ = proof
    sharded = set(got[0]["built"]["sharded"])
    shapes = {tuple(p.shape) for k, p in model.named_parameters()
              if k in sharded}
    assert len(shapes) > 10
    for r in got:
        gathers = [shape for (group, op, shape), n in r["tally"].items()
                   if op == "all_gather"]
        assert gathers
        bad = [s for s in gathers if tuple(s) in shapes]
        assert not bad, f"parameter-shaped all-gathers: {bad[:5]}"


def test_the_model_axis_carries_per_layer_collectives(proof):
    got = proof[0]
    for r in got:
        model = sum(n for (group, _, _), n in r["tally"].items()
                    if group == P.MODEL_AXIS)
        assert model >= 20, r["tally"]
        ops = {op for (group, op, _) in r["tally"] if group == P.MODEL_AXIS}
        assert ops == {"all_gather", "all_reduce"}, ops
        assert all(np.isfinite(v) for v in r["metrics"].values())
        assert r["metrics"]["l_con"] > 0


def test_a_rank_holds_about_half_the_state(proof):
    got, model, state, old = proof
    full = M.state_bytes(model, state, old)
    for r in got:
        assert r["bytes"] <= 0.65 * full, (r["bytes"], full)


def test_the_mesh_refuses_what_it_does_not_run(proof):
    """A world of another size is refused; what the mesh once refused
    builds."""
    want = ["size", "remat", "remat_early", "stem_s2d", "bf16_norm",
            "bf16_norm_early", "gn", "nan_guard", "validate", "regularizer"]
    for r in proof[0]:
        assert [w for w, _ in r["refusals"]] == want, r["refusals"]
        assert "3 x 2 mesh needs 6 ranks" in r["refusals"][0][1]
        assert all(msg is None for _, msg in r["refusals"][1:]), \
            r["refusals"]


def test_the_mesh_builds_the_regularizer_state_from_shards(proof):
    full = M.rw_state()
    for r in proof[0]:
        _, m = r["place"]
        assert r["reg"]["sharded"] == sorted(
            k for k, dim in P.channel_sharding(
                N_MODEL, full.old_params, MIN_SIZE).items()
            if dim is not None)
        assert r["reg"]["sharded"]
        for field in W.REG_FIELDS:
            tree = getattr(full, field)
            assert (tree is None) == (r["reg"][field] is None), field
            if tree is None:
                continue
            mine = shard_state(tree, N_MODEL, m, MIN_SIZE)
            assert set(mine) == set(r["reg"][field]), field
            for k, v in mine.items():
                assert torch.equal(r["reg"][field][k], v), (field, k)


def test_a_1x2_mesh_validates_each_pixel_once(tmp_path):
    """The validate step's confusion counts sum over the data group: on a
    1 x 2 mesh its total is the batch's labelled pixels (a sum over the
    world would count each twice), and it is the one-process step's up
    to the pixels whose near-tied predictions differ (float32)."""
    W.run_ranks(M.eval_1x2_worker, 2, tmp_path, str(tmp_path))
    got = [torch.load(tmp_path / f"eval{r}.pt") for r in (0, 1)]
    cfg, model, model_old, _, old = M.proof_start()
    batch = M.proof_batch(cfg)
    hist, losses, preds = make_eval_step(cfg, model, model_old,
                                         device="cpu")(
        None, batch, empty_confusion(cfg.tot_classes, "cpu"), old)
    labels = batch["label"]
    labelled = int((labels < cfg.tot_classes).sum())
    for r in got:
        assert int(r["hist"].sum()) == labelled == labels.size
        assert torch.equal(r["hist"], got[0]["hist"])
        assert torch.equal(r["preds"], got[0]["preds"])
        assert r["losses"] == got[0]["losses"]
        n_mism = int((r["preds"] != preds).sum())
        assert n_mism <= 1e-3 * labels.size, n_mism
        assert int((r["hist"] - hist).abs().sum()) <= 2 * n_mism
        for k, v in losses.items():
            np.testing.assert_allclose(r["losses"][k], float(v), rtol=1e-5,
                                       err_msg=k)
