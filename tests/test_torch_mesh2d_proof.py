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

The mesh's refusals (a world of another size; GroupNorm ABN, the five
execution options, nan_guard, the regularizers and the validate step,
which it does not run yet) are named errors.
"""

import functools

import numpy as np
import pytest
import torch

import torch_dp_workers as W
import torch_mesh2d_workers as M
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from ucd_torch import parallel as P
from ucd_torch.engine.state import shard_state

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
    want = ["size", "remat", "remat_early", "stem_s2d", "bf16_norm",
            "bf16_norm_early", "gn", "nan_guard", "validate", "regularizer"]
    for r in proof[0]:
        assert [w for w, _ in r["refusals"]] == want, r["refusals"]
        assert "3 x 2 mesh needs 6 ranks" in r["refusals"][0][1]
