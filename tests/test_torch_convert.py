"""Weight bridge (ucd_torch/models/convert.py) and the npz codec of
ucd_torch/engine/export.py against the JAX package's variables and its
ml_dtypes bf16 encoding."""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch
from flax.traverse_util import flatten_dict

from torch_port_helpers import random_flat_variables
from ucd_torch.engine.export import (_bf16_bits, _bf16_from_bits,
                                     load_inference, save_inference)
from ucd_torch.models import (IncrementalSegmentationModel,
                              flax_to_state_dict, state_dict_to_flax)
from ucd_tpu.models.segmentation import \
    IncrementalSegmentationModel as JaxModel


def test_flax_state_dict_round_trip_bit_exact():
    jm = JaxModel(classes=(16, 5), backbone="resnet18", pooling_size=4)
    flat = random_flat_variables(jm, (32, 32), seed=0)
    back = state_dict_to_flax(flax_to_state_dict(flat))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_jax_init_tree_loads_strict():
    """Every leaf of a JAX `model.init` tree lands in the port's model
    under strict=True (no key left over, none missing), with HWIO kernels
    transposed to OIHW."""
    jm = JaxModel(classes=(16, 1), backbone="resnet50", output_stride=8,
                  pooling_size=4)
    v = jax.jit(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                train=False))()
    flat = {f"{col}/{k}": np.asarray(a) for col in ("params", "batch_stats")
            for k, a in flatten_dict(v[col], sep="/").items()}
    tm = IncrementalSegmentationModel((16, 1), backbone="resnet50",
                                      output_stride=8, pooling_size=4)
    sd = flax_to_state_dict(flat)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd, strict=True)
    k = flat["params/body/mod4_block2/conv2/kernel"]          # (3,3,I,O)
    np.testing.assert_array_equal(
        tm.body.mod4_block2.conv2.weight.detach().numpy(),
        k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        tm.head.map_bn.bn.running_var.numpy(),
        flat["batch_stats/head/map_bn/bn/var"])
    np.testing.assert_array_equal(tm.cls_1.bias.detach().numpy(),
                                  flat["params/cls_1/bias"])


def test_bf16_bits_match_ml_dtypes():
    """The npz stores bf16 as uint16 bits: the port decodes them to the
    values ml_dtypes gives, and encodes f32 to the same bits (round to
    nearest even), edge values included."""
    rng = np.random.RandomState(0)
    x = np.concatenate([
        rng.randn(4096).astype(np.float32) * 10.0,
        np.array([0.0, -0.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 3.4e38,
                  1e-40, np.inf, -np.inf], np.float32)])
    bits = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(_bf16_bits(x), bits)
    want = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(_bf16_from_bits(bits).float().numpy(),
                                  want)


def test_port_npz_loads_in_jax_package(tmp_path):
    """save_inference writes the JAX package's format: ucd_tpu's
    load_inference reads it back to the same variables (bf16 params as
    ml_dtypes bf16, f32 statistics), and the port reads it back too."""
    from ucd_tpu.engine.export import load_inference as jax_load

    tm = IncrementalSegmentationModel((16, 1), backbone="resnet18",
                                      pooling_size=4)
    tm.init_weights(torch.Generator().manual_seed(0))
    meta = save_inference(tm, str(tmp_path / "m"), dataset="ade")
    assert meta["path"].endswith("m.npz") and os.path.exists(meta["path"])
    jmodel, jvars, jmeta = jax_load(meta["path"])
    assert jmodel.classes == (16, 1) and jmeta["dataset"] == "ade"
    assert jmodel.dtype == jnp.bfloat16
    jflat = {f"{col}/{k}": np.asarray(a) for col in ("params", "batch_stats")
             for k, a in flatten_dict(jvars[col], sep="/").items()}
    mine = state_dict_to_flax(tm.state_dict())
    assert sorted(jflat) == sorted(mine)
    for k, v in mine.items():
        if k.startswith("params/"):
            assert jflat[k].dtype == ml_dtypes.bfloat16, k
            v = v.astype(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(jflat[k], v, err_msg=k)
    back, _ = load_inference(meta["path"], device="cpu")
    assert back.dtype == torch.bfloat16
    assert back.body.mod1_conv1.weight.dtype == torch.bfloat16
    assert back.cls_0.weight.dtype == torch.float32
