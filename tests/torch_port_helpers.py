"""Shared helpers of the ucd_torch parity tests (tests/test_torch_*.py):
seeded flax-keyed weights made with numpy, a jitted JAX forward, layout
conversion, the argmax near-tie rule and the contrastive term's seeded
inputs."""

import numpy as np
import pytest


def random_flat_variables(jax_model, input_hw, seed=0):
    """Flat `params/...` + `batch_stats/...` numpy f32 arrays for
    `jax_model`, drawn from a seeded numpy generator: He-magnitude conv
    kernels (finite activations through every block) and non-trivial BN
    affine parameters and statistics (fresh init is scale-free and would
    hide mean/var layout bugs)."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.key(0), jnp.zeros((1, *input_hw, 3)), train=False))
    rng = np.random.RandomState(seed)
    flat = {}
    for key, s in sorted(flatten_dict(shapes, sep="/").items()):
        leaf = key.rsplit("/", 1)[1]
        if leaf == "kernel":
            v = rng.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[:3]))
        elif leaf == "scale":
            v = np.abs(rng.randn(*s.shape)) * 0.3 + 0.8
        elif leaf in ("bias", "mean"):
            v = rng.randn(*s.shape) * 0.1
        elif leaf == "var":
            v = np.abs(rng.randn(*s.shape)) * 0.3 + 0.7
        else:
            raise KeyError(key)
        flat[key] = v.astype(np.float32)
    return flat


def unflatten(flat):
    from flax.traverse_util import unflatten_dict
    return unflatten_dict(flat, sep="/")


def jax_forward(jax_model, flat, x):
    """Eval-mode `model.apply` (jitted) -> numpy (outputs, feats)."""
    import jax

    fn = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))
    out, feats = fn(unflatten(flat), x)
    return np.asarray(out), {k: np.asarray(v) for k, v in feats.items()}


def nhwc(t):
    """NCHW torch tensor -> NHWC float32 numpy."""
    return t.detach().float().permute(0, 2, 3, 1).cpu().numpy()


def assert_argmax_close(got, want, up, gap_tol=1e-4, rate_tol=1e-3):
    """Argmax maps equal except at near-exact ties: a mismatch is allowed
    only where the top-2 gap of the upsampled logits `up` (B, H, W, C) is
    below `gap_tol`, and at a rate below `rate_tol`."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    mism = got != want
    if mism.any():
        top2 = np.sort(up, axis=-1)
        gap = top2[..., -1] - top2[..., -2]
        assert gap[mism].max() < gap_tol, (
            f"{mism.sum()} real argmax mismatches, max gap {gap[mism].max()}")
        assert mism.mean() < rate_tol, mism.mean()


def make_inputs(seed, B=2, H=32, W=32, h=8, w=8, N=16, C=6, max_label=5,
                ignore=True, label_dtype=np.int32):
    """Seeded numpy (f_n, labels, l_po, f_o) of the contrastive term: NHWC
    features and old logits at (h, w), labels at (H, W) with a 255 corner."""
    rs = np.random.RandomState(seed)
    f_n = rs.randn(B, h, w, N).astype(np.float32)
    f_o = rs.randn(B, h, w, N).astype(np.float32)
    l_po = (rs.randn(B, h, w, C) * 3).astype(np.float32)
    labels = rs.randint(0, max_label + 1, size=(B, H, W)).astype(label_dtype)
    if ignore:
        labels[0, :6, :6] = 255
    return f_n, labels, l_po, f_o


def both_batches(inputs, max_label):
    """The contrastive batch of `inputs` in both packages: (torch, jax)."""
    import jax.numpy as jnp
    import torch

    from ucd_torch.ops import contrastive as TCon
    from ucd_tpu.ops import contrastive as JCon

    f_n, labels, l_po, f_o = inputs
    bj = JCon.build_contrastive_batch(jnp.array(f_n), jnp.array(labels),
                                      jnp.array(l_po), jnp.array(f_o),
                                      max_label)
    bt = TCon.build_contrastive_batch(
        torch.from_numpy(f_n), torch.from_numpy(labels),
        torch.from_numpy(l_po), torch.from_numpy(f_o), max_label)
    return bt, bj


@pytest.fixture
def one_torch_thread():
    """Run the test's torch work on one thread, restored afterwards. The
    suite runs in several worker processes at once, and torch's default of
    one thread per core then oversubscribes the host many times over
    (train-loop tests ran 20-40x slower in parallel than alone with it)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def free_tmp_path(tmp_path):
    """Empty the test's tmp_path after it ran: pytest keeps every test's
    directory until the session ends, and a regularized step's checkpoint
    holds eight parameter-sized trees (about 0.75 GB at ResNet-50)."""
    import shutil

    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)
