"""ucd_torch/engine/predictor.py vs the JAX Predictor on the same weights:
the single-view serving path (fused and dense argmax) and test-time
augmentation with flip and scales (0.75, 1.0) under each fusion mode. The
0.75 scale downsamples the images and upsamples the logits back, so this
also holds the port's antialiased resize to jax.image.resize. f32
throughout; predictions must agree on >= 99.9% of pixels (near-ties may
flip), fused probabilities to 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import random_flat_variables, unflatten
from ucd_torch.engine.predictor import Predictor
from ucd_torch.models import IncrementalSegmentationModel, flax_to_state_dict
from ucd_tpu.engine.predictor import Predictor as JaxPredictor
from ucd_tpu.models.segmentation import \
    IncrementalSegmentationModel as JaxModel

CLASSES = (19, 2)


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(classes=CLASSES, backbone="resnet50", pooling_size=4,
                  dtype=jnp.float32)
    flat = random_flat_variables(jm, (32, 32), seed=5)
    # random weights give logits ~1e4, where f32 rounding alone moves the
    # softmax by ~1e-3; scale the classifiers to a trained model's O(10)
    for i in range(len(CLASSES)):
        flat[f"params/cls_{i}/kernel"] *= 1e-3
    tm = IncrementalSegmentationModel(CLASSES, backbone="resnet50",
                                      pooling_size=4)
    tm.load_state_dict(flax_to_state_dict(flat), strict=True)
    tm = tm.to(memory_format=torch.channels_last)
    imgs = np.random.RandomState(6).randint(0, 255, (2, 32, 32, 3), np.uint8)
    return jm, unflatten(flat), tm, imgs


@pytest.mark.parametrize("fused", [True, False])
def test_predict_labels_matches_jax(pair, fused):
    jm, jv, tm, imgs = pair
    want = np.asarray(JaxPredictor(jm, jv, fused=False).predict_labels(imgs))
    got = Predictor(tm, fused=fused, device="cpu").predict_labels(imgs)
    assert got.dtype == torch.uint8 and got.shape == (2, 32, 32)
    got = got.numpy()
    assert (got == want).mean() >= 0.999, (got != want).mean()
    assert len(np.unique(want)) > 1


@pytest.mark.parametrize("mode", ["mean", "max", "voting"])
def test_tta_matches_jax(pair, mode):
    jm, jv, tm, imgs = pair
    kw = dict(fusion_mode=mode, flip=True, scales=(0.75, 1.0))
    want_p, want_f = JaxPredictor(jm, jv, **kw)(imgs)
    p = Predictor(tm, device="cpu", **kw)
    got_p, got_f = p(imgs)
    assert got_f.shape == want_f.shape == (2, 32, 32, sum(CLASSES))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-4)
    assert (got_p.numpy() == np.asarray(want_p)).mean() >= 0.999
    # predict_labels takes the same fusion for a TTA configuration
    labels = p.predict_labels(imgs)
    np.testing.assert_array_equal(labels.numpy(),
                                  got_p.numpy().astype(np.uint8))
