"""ucd_torch model (models/{layers,resnet,deeplab,segmentation}.py) vs the
JAX model: the eval-mode forward of the port on weights passed through
`flax_to_state_dict` equals `model.apply(..., train=False)`.

Tolerance: f32 compares max|d| <= 1e-4 * max|ref| per output (the two
frameworks sum convolutions in different orders; the measured gap is
~1e-6). bf16 compares max|d| <= 5e-2 * max|ref|: both sides round every
conv output to bf16, at places that differ by a ulp, and the difference
compounds through the body."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_forward, nhwc, random_flat_variables
from ucd_torch.models import IncrementalSegmentationModel, flax_to_state_dict
from ucd_tpu.models.segmentation import \
    IncrementalSegmentationModel as JaxModel

CLASSES = (16, 1)

CASES = {
    # backbone, output stride, input size, pooling_size, dtype
    # map 4x4, pooling >= map (even window)
    "r18_os16_pool_ge_even": ("resnet18", 16, 64, 32, "float32"),
    # map 5x5, pooling >= map (odd window)
    "r18_os8_pool_ge_odd": ("resnet18", 8, 40, 32, "float32"),
    # bottleneck, map 3x3, 2x2 window < map (asymmetric replicate pad)
    "r50_os16_pool_lt": ("resnet50", 16, 48, 2, "float32"),
    # bottleneck at output stride 8, map 4x4
    "r50_os8": ("resnet50", 8, 32, 32, "float32"),
    "r18_os16_bf16": ("resnet18", 16, 64, 32, "bfloat16"),
}


def _pair(backbone, os_, size, pooling, dtype, seed):
    jm = JaxModel(classes=CLASSES, backbone=backbone, output_stride=os_,
                  pooling_size=pooling,
                  dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    flat = random_flat_variables(jm, (size, size), seed=seed)
    tm = IncrementalSegmentationModel(
        CLASSES, backbone=backbone, output_stride=os_, pooling_size=pooling,
        dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    tm.load_state_dict(flax_to_state_dict(flat), strict=True)
    return jm, flat, tm.to(memory_format=torch.channels_last).eval()


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_forward_matches_jax(case):
    backbone, os_, size, pooling, dtype = CASES[case]
    jm, flat, tm = _pair(backbone, os_, size, pooling, dtype, seed=1)
    x = (np.random.RandomState(2).randn(2, size, size, 3) * 0.5).astype(
        np.float32)
    want_out, want = jax_forward(jm, flat, jnp.asarray(x))
    with torch.no_grad():
        out, feats = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = {k: nhwc(v) for k, v in feats.items()}
    got["outputs"], want["outputs"] = nhwc(out), want_out.astype(np.float32)
    assert feats["sem"].dtype == torch.float32
    assert got["sem"].shape == (2, -(-size // os_), -(-size // os_),
                                sum(CLASSES))
    rel = 5e-2 if dtype == "bfloat16" else 1e-4
    for k in ("sem", "outputs", "body", "pre_logits"):
        ref = want[k].astype(np.float32)
        assert got[k].shape == ref.shape, k
        err = np.abs(got[k] - ref).max()
        assert err <= rel * np.abs(ref).max(), (k, err, np.abs(ref).max())


def test_uint8_input_normalized_on_device():
    """uint8 images take the model's own ImageNet normalization, as in the
    JAX model."""
    jm, flat, tm = _pair("resnet18", 16, 32, 32, "float32", seed=3)
    x = np.random.RandomState(4).randint(0, 255, (1, 32, 32, 3), np.uint8)
    _, want = jax_forward(jm, flat, jnp.asarray(x))
    with torch.no_grad():
        sem = tm.forward_sem(torch.from_numpy(x).permute(0, 3, 1, 2))
    ref = want["sem"]
    assert np.abs(nhwc(sem) - ref).max() <= 1e-4 * np.abs(ref).max()


def test_init_weights_is_seeded_and_jax_scaled():
    """init_weights draws from the generator alone (same seed, same
    weights) with the JAX init's scales."""
    def make(seed):
        m = IncrementalSegmentationModel((16, 1), backbone="resnet18",
                                         pooling_size=4)
        return m.init_weights(torch.Generator().manual_seed(seed))

    a, b, c = make(0), make(0), make(1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["body.mod1_conv1.weight"],
                           sc["body.mod1_conv1.weight"])
    w = sa["body.mod2_block1.conv1.weight"]          # he_normal, fan_in 576
    assert abs(w.std().item() - np.sqrt(2.0 / 576)) < 0.1 * np.sqrt(2 / 576)
    assert (sa["cls_0.bias"] == 0).all()
    assert (sa["body.mod1_bn1.bn.running_var"] == 1).all()
