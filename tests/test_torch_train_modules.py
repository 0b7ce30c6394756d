"""Train-mode pieces of the ucd_torch model vs the JAX model, on one numpy
variable tree handed to both packages:

  * train-mode forward of a ResNet-18 os-16 model against
    `model.apply(..., train=True, mutable=["batch_stats"])` in f32 with the
    cancellation-free BatchNorm variance on the JAX side (`stable_norm`):
    outputs, `sem`, attention maps AND the new batch_stats, which shows that
    the running variance takes the biased batch variance as flax's does;
  * `fix_bn`: running statistics normalize and stay untouched, the ASPP
    pooling branch takes the eval sliding pool, gradients still flow;
  * `init_new_classifier`, `merge_old_params`, `trainable_mask`;
  * f32 master weights under the bf16 compute policy.

Tolerance: f32 on both sides with different summation orders; outputs
within 1e-4 of max|ref| (measured ~1e-6), batch statistics rtol 1e-4 /
atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from torch_port_helpers import nhwc, random_flat_variables, unflatten
from ucd_torch.models import (IncrementalSegmentationModel,
                              flax_to_state_dict, init_new_classifier,
                              load_flax_variables, merge_old_params,
                              module_to_flax, state_dict_to_flax,
                              trainable_mask)
from ucd_tpu.models import layers as jax_layers
from ucd_tpu.models import segmentation as JS

CLASSES = (5, 2)


@pytest.fixture
def stable_norm():
    """The JAX side with the cancellation-free variance, as
    make_model(cfg with stable_norm=True) sets it; restored afterwards."""
    prev = jax_layers.DEFAULT_FAST_VARIANCE[0]
    jax_layers.DEFAULT_FAST_VARIANCE[0] = False
    yield
    jax_layers.DEFAULT_FAST_VARIANCE[0] = prev


def _pair(size, pooling, seed, classes=CLASSES, dtype=torch.float32):
    jm = JS.IncrementalSegmentationModel(
        classes=classes, backbone="resnet18", output_stride=16,
        pooling_size=pooling,
        dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    flat = random_flat_variables(jm, (size, size), seed=seed)
    tm = IncrementalSegmentationModel(classes, backbone="resnet18",
                                      output_stride=16, pooling_size=pooling,
                                      dtype=dtype)
    load_flax_variables(tm, flat)
    return jm, flat, tm.to(memory_format=torch.channels_last)


def _close(got, ref, rel=1e-4):
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


@pytest.mark.parametrize("size", [32, 64])
def test_train_forward_and_batch_stats_match_flax(size, stable_norm):
    jm, flat, tm = _pair(size, pooling=2, seed=size)
    x = (np.random.RandomState(1).randn(3, size, size, 3) * 0.7).astype(
        np.float32)
    (want_out, want), mut = jax.jit(
        lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
            unflatten(flat), jnp.asarray(x))
    tm.train()
    out, feats = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(nhwc(out), np.asarray(want_out))
    for k in ("sem", "body", "pre_logits"):
        _close(nhwc(feats[k]), np.asarray(want[k]))
    new_stats = {"batch_stats/" + k: np.asarray(v) for k, v in
                 flatten_dict(mut["batch_stats"], sep="/").items()}
    got = {k: v for k, v in module_to_flax(tm).items()
           if k.startswith("batch_stats/")}
    assert set(got) == set(new_stats) and len(got) > 40
    moved = 0
    for k, ref in new_stats.items():
        np.testing.assert_allclose(got[k], ref, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
        moved += not np.allclose(ref, flat[k], rtol=1e-3)
    assert moved == len(new_stats)  # every statistic took the batch's
    # the unbiased update (torch's own) would fail the bound above: at the
    # pooling branch's norm n is the batch size, n/(n-1) = 1.5
    k = "batch_stats/head/global_pooling_bn/bn/var"
    biased = (new_stats[k] - 0.9 * flat[k]) / 0.1
    unbiased_update = 0.9 * flat[k] + 0.1 * biased * 3 / 2
    assert not np.allclose(got[k], unbiased_update, rtol=1e-2)
    # params are untouched by a forward
    for k, v in module_to_flax(tm).items():
        if k.startswith("params/"):
            np.testing.assert_array_equal(v, flat[k])


def test_fix_bn_runs_eval_norms_and_sliding_pool_with_gradients(stable_norm):
    size = 64  # map 4x4, pooling 2 < map: the sliding pool differs from
    # the global pool
    jm, flat, tm = _pair(size, pooling=2, seed=7)
    x = (np.random.RandomState(2).randn(2, size, size, 3) * 0.7).astype(
        np.float32)
    (_, want), mut = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, fix_bn=True, mutable=["batch_stats"]))(
            unflatten(flat), jnp.asarray(x))
    for k, v in flatten_dict(mut["batch_stats"], sep="/").items():
        np.testing.assert_array_equal(np.asarray(v), flat["batch_stats/" + k])
    tm.train(False)  # train and not fix_bn
    feats = tm.forward_feats(torch.from_numpy(x).permute(0, 3, 1, 2),
                             attention=True)
    for k in ("sem", "body", "pre_logits"):
        _close(nhwc(feats[k]), np.asarray(want[k]))
    after = module_to_flax(tm)
    for k in flat:
        np.testing.assert_array_equal(after[k], flat[k])
    feats["sem"].square().mean().backward()
    assert tm.body.mod1_conv1.weight.grad.abs().max() > 0
    # and the train-mode forward (global pool, batch statistics) differs
    tm.train()
    sem_train = tm.forward_feats(torch.from_numpy(x).permute(0, 3, 1, 2)
                                 )["sem"]
    assert not np.allclose(nhwc(sem_train), np.asarray(want["sem"]),
                           rtol=1e-2, atol=1e-3)


def _flat_params(flat):
    return {k[len("params/"):]: v for k, v in flat.items()
            if k.startswith("params/")}


@pytest.mark.parametrize("new_classes", [1, 5])
def test_init_new_classifier_matches_jax(new_classes):
    jm, flat, _ = _pair(32, 2, seed=3, classes=(6, new_classes))
    params = unflatten(_flat_params(flat))
    want = flatten_dict(JS.init_new_classifier(
        jax.tree_util.tree_map(jnp.asarray, params), new_classes), sep="/")
    got = state_dict_to_flax(init_new_classifier(flax_to_state_dict(flat),
                                                 new_classes))
    for k, v in want.items():
        np.testing.assert_allclose(got["params/" + k], np.asarray(v),
                                   rtol=1e-6, atol=0, err_msg=k)
    b = got["params/cls_1/bias"]
    np.testing.assert_allclose(
        b, flat["params/cls_0/bias"][0] - np.log(new_classes + 1), rtol=1e-6)
    assert got["params/cls_0/bias"][0] == b[0]
    np.testing.assert_array_equal(got["params/cls_0/bias"][1:],
                                  flat["params/cls_0/bias"][1:])
    np.testing.assert_array_equal(
        got["params/cls_1/kernel"][..., -1],
        flat["params/cls_0/kernel"][..., 0])
    # pure: the input mapping is untouched
    sd = flax_to_state_dict(flat)
    before = {k: v.clone() for k, v in sd.items()}
    init_new_classifier(sd, new_classes)
    assert all(torch.equal(sd[k], before[k]) for k in sd)


def test_merge_old_params_matches_jax():
    _, new_flat, _ = _pair(32, 2, seed=4, classes=(6, 2))
    _, old_flat, _ = _pair(32, 2, seed=5, classes=(6,))
    want = flatten_dict(JS.merge_old_params(unflatten(new_flat),
                                            unflatten(old_flat)), sep="/")
    got = state_dict_to_flax(merge_old_params(flax_to_state_dict(new_flat),
                                              flax_to_state_dict(old_flat)))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(got["params/cls_1/kernel"],
                                  new_flat["params/cls_1/kernel"])
    np.testing.assert_array_equal(got["params/cls_0/kernel"],
                                  old_flat["params/cls_0/kernel"])


@pytest.mark.parametrize("kw", [
    dict(step=0), dict(step=1), dict(step=0, freeze_cls0_always=True),
    dict(step=1, freeze_body=True), dict(step=1, fix_bn=True),
    dict(step=2, freeze_body=True, fix_bn=True)])
def test_trainable_mask_matches_jax(kw):
    _, flat, tm = _pair(32, 2, seed=6)
    want = flatten_dict(JS.trainable_mask(unflatten(_flat_params(flat)),
                                          **kw), sep="/")
    names = [n for n, _ in tm.named_parameters()]
    got = trainable_mask(names, **kw)
    params = dict(tm.named_parameters())
    by_flax_key = {next(iter(state_dict_to_flax({n: params[n]}))): got[n]
                   for n in names}
    assert {k[len("params/"):]: v for k, v in by_flax_key.items()} == want
    assert any(got.values()) and (kw == dict(step=0) or not all(got.values()))


def test_f32_masters_under_the_bf16_policy():
    """bf16 compute, f32 parameters: every conv casts its f32 weight at the
    call, the gradients arrive in f32, and `sem` is f32."""
    _, flat, tm = _pair(32, 2, seed=8, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    seen = {}
    hook = tm.body.mod2_block1.conv1.register_forward_hook(
        lambda m, i, o: seen.update(inp=i[0].dtype, out=o.dtype))
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 3, 32, 32)
                         .astype(np.float32))
    tm.train()
    sem = tm.forward_feats(x)["sem"]
    hook.remove()
    assert seen == {"inp": torch.bfloat16, "out": torch.bfloat16}
    assert sem.dtype == torch.float32
    sem.square().mean().backward()
    for n, p in tm.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, n
    # the masters hold values bf16 cannot: nothing was rounded on load
    w = tm.body.mod2_block1.conv1.weight
    assert not torch.equal(w, w.bfloat16().float())
    # a serving model may keep bf16 weights (param_dtype)
    serving = IncrementalSegmentationModel(
        CLASSES, backbone="resnet18", pooling_size=2, dtype=torch.bfloat16,
        param_dtype=torch.bfloat16)
    assert serving.body.mod1_conv1.weight.dtype == torch.bfloat16
    assert serving.cls_0.weight.dtype == torch.float32


def test_float64_is_a_test_only_dtype_that_runs_everything_in_f64():
    tm = IncrementalSegmentationModel(CLASSES, backbone="resnet18",
                                      pooling_size=2, dtype=torch.float64)
    tm.init_weights(torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float64 for p in tm.parameters())
    x = torch.from_numpy(np.random.RandomState(4).randint(
        0, 255, (2, 3, 32, 32)).astype(np.uint8))
    tm.train()
    out, feats = tm(x)
    assert out.dtype == torch.float64
    assert all(v.dtype == torch.float64 for v in feats.values())
    assert tm.body.mod1_bn1.bn.running_var.dtype == torch.float64
