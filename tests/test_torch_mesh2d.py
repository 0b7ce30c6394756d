"""The 2-D data x model mesh's pure parts against the JAX package's
(no processes): the hybrid ordering and its refusals on the fake devices
of tests/test_hybrid_mesh.py, `channel_sharding`'s set of sharded leaves
on ResNet-50 and ResNet-101 (the JAX variables carried across by
ucd_torch/models/convert.py), and `shard_state` -> `unshard_state` bit
for bit."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.sharding import PartitionSpec

from test_hybrid_mesh import fake_dev
from ucd_torch import config as TC
from ucd_torch import parallel as P
from ucd_torch.engine.state import shard_rows, shard_state, unshard_state
from ucd_torch.models import flax_to_state_dict, make_model
from ucd_torch.parallel.mesh import _hybrid_device_order
from ucd_tpu import config as JC
from ucd_tpu import parallel as JP
from ucd_tpu.models import make_model as jax_make_model
from ucd_tpu.parallel.mesh import _hybrid_device_order as jax_order

# every case of tests/test_hybrid_mesh.py: (devices, n_model)
ORDER_CASES = {
    "interleaved_slices": ([fake_dev(i, slice_index=i % 2)
                            for i in range(8)], 4),
    "process_index_fallback": ([fake_dev(i, process_index=i // 2)
                                for i in range(8)], 2),
    "straddle_refused": ([fake_dev(i, slice_index=i // 3)
                          for i in range(6)], 2),
    **{f"two_slices_{per}x{n}": ([fake_dev(i, slice_index=i % 2)
                                  for i in range(2 * per)], n)
       for per, n in ((2, 2), (4, 2), (4, 4))},
    "two_slices_n_model_4_refused": ([fake_dev(i, slice_index=i % 2)
                                      for i in range(4)], 4),
    "single_slice_tpu_pod": ([fake_dev(i, process_index=i // 2,
                                       platform="tpu") for i in range(8)], 4),
    "hosts_n_model_4_refused": ([fake_dev(i, process_index=i // 2)
                                for i in range(8)], 4),
}


def outcome(fn, devices, n_model):
    try:
        return [d.id for d in fn(devices, n_model)]
    except ValueError:
        return "refused"


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_hybrid_order_matches_jax(case):
    devices, n_model = ORDER_CASES[case]
    want = outcome(jax_order, devices, n_model)
    assert outcome(_hybrid_device_order, devices, n_model) == want
    assert (want == "refused") == ("refused" in case)


def test_hybrid_order_groups_ranks_by_node():
    """The port's own records: `node` keys the domain; ranks keep their
    order within a node; a node whose rank count n_model does not divide
    is refused."""
    recs = [types.SimpleNamespace(id=r, node=f"host{r % 2}")
            for r in range(8)]
    assert [d.id for d in _hybrid_device_order(recs, 4)] == \
        [0, 2, 4, 6, 1, 3, 5, 7]
    with pytest.raises(ValueError, match="NVLink domain"):
        _hybrid_device_order(recs[:6], 4)


def test_indivisible_rank_count_refused():
    with pytest.raises(ValueError, match="must divide"):
        JP.make_mesh_2d_hybrid(3)
    with pytest.raises(ValueError, match="must divide"):
        P.make_mesh_2d_hybrid(3, ranks=[types.SimpleNamespace(id=i, node=0)
                                        for i in range(8)])


def test_a_2d_mesh_needs_a_process_group_of_its_size():
    with pytest.raises(ValueError, match="needs 4 ranks"):
        P.make_mesh_2d(2, 2)


def _port_key(flax_key, ndim):
    """The port's name of a JAX leaf, through the weight bridge."""
    names = [k for k in flax_to_state_dict(
        {flax_key: np.zeros((1,) * ndim, np.float32)})
        if not k.endswith("num_batches_tracked")]
    assert len(names) == 1
    return names[0]


@pytest.mark.parametrize("backbone", ["resnet50", "resnet101"])
def test_channel_sharding_matches_jax(backbone):
    args = dict(dataset="voc", task="15-5s", step=1, method="UCD",
                backbone=backbone, crop_size=64, batch_size=2)
    model_j = jax_make_model(JC.make_config(**args))
    shapes = jax.eval_shape(lambda: model_j.init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False))
    flat = flatten_dict(shapes, sep="/")
    with torch.device("meta"):
        model_t = make_model(TC.make_config(**args))
    sd = model_t.state_dict()
    port = {k: _port_key(k, len(v.shape)) for k, v in flat.items()}
    assert set(port.values()) == {k for k in sd
                                  if not k.endswith("num_batches_tracked")}
    for n_model in (2, 4):
        mesh = JP.make_mesh_2d(1, n_model)
        for min_size in (64, 256):
            want = {k for k, s in flatten_dict(
                JP.channel_sharding(mesh, shapes, min_size),
                sep="/").items() if s.spec != PartitionSpec()}
            # JAX shards the trailing dim of every leaf it shards
            assert all(
                flatten_dict(JP.channel_sharding(mesh, shapes, min_size),
                             sep="/")[k].spec[-1] == JP.MODEL_AXIS
                for k in want)
            got = P.channel_sharding(n_model, sd, min_size)
            assert {port[k] for k in want} == {
                k for k, dim in got.items() if dim is not None}
            # the port shards OIHW's leading dim, the one the bridge
            # carries JAX's trailing dim to
            assert {dim for dim in got.values()} <= {0, None}
            # the momentum, named as the parameters, shards alike
            params = dict(model_t.named_parameters())
            assert P.channel_sharding(n_model, params, min_size) == {
                k: got[k] for k in params}
            if min_size == 256:
                # ResNet: conv3 (256..2048), the inner 256s and 512s, the
                # projections and the ASPP; never the classifiers
                assert got["body.mod2_block1.conv3.weight"] == 0
                assert got["body.mod2_block1.conv1.weight"] is None
                assert got["body.mod4_block2.conv2.weight"] == 0
                assert got["cls_0.weight"] is None


def _random_state(seed, min_size):
    """A ResNet-18 model's state dict with seeded values, its momentum and
    a donor's (fewer classifiers)."""
    cfg = TC.make_config(dataset="voc", task="15-5s", step=1, method="UCD",
                         crop_size=64, batch_size=2)
    import dataclasses
    cfg = dataclasses.replace(cfg, backbone="resnet18")
    g = torch.Generator().manual_seed(seed)
    sd = {k: torch.randn(v.shape, generator=g, dtype=torch.float64)
          if v.is_floating_point() else v.clone()
          for k, v in make_model(cfg).state_dict().items()}
    return {k: v.contiguous(memory_format=torch.channels_last)
            if v.ndim == 4 else v for k, v in sd.items()}


@pytest.mark.parametrize("n_model,min_size", [(2, 64), (4, 64), (2, 256),
                                              (2, 512)])
def test_shard_then_unshard_is_the_identity(n_model, min_size):
    sd = _random_state(0, min_size)
    shards = [shard_state(sd, n_model, m, min_size) for m in range(n_model)]
    back = unshard_state(shards, sd, min_size)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    for k, dim in P.channel_sharding(n_model, sd, min_size).items():
        for m in range(n_model):
            part = shards[m][k]
            if dim is None:
                assert part is sd[k]
                continue
            assert part.shape[0] * n_model == sd[k].shape[0]
            assert part.is_contiguous(memory_format=torch.channels_last) \
                if part.ndim == 4 else part.is_contiguous()
            rows = shard_rows(k, sd[k].shape[0], n_model, m, min_size)
            assert torch.equal(part, sd[k][rows])


def test_map_bn_shard_holds_a_slice_of_each_branch():
    """Over sharded ASPP branches (256 >= min_size) `map_bn` holds each
    branch's slice, in the order the rank concatenates them; over whole
    branches (min_size 512) a contiguous slice of the concatenation."""
    rows = shard_rows("head.map_bn.bn.weight", 1024, 2, 1, 256)
    assert rows.tolist() == [i * 256 + 128 + j for i in range(4)
                             for j in range(128)]
    rows = shard_rows("head.map_bn.bn.weight", 1024, 2, 1, 512)
    assert rows.tolist() == list(range(512, 1024))
    assert shard_rows("head.red_bn.bn.weight", 256, 4, 3, 64).tolist() == \
        list(range(192, 256))
