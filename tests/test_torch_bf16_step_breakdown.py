"""Where the bf16 trajectory's first step leaves the JAX band: the port's
bf16 UCD step against the JAX package's bf16 step from the same weights
and batch, tensor group by tensor group, each beside the float64 step.

tests/test_torch_bf16_trajectory.py holds the step-1 update-norm ratio
(bf16 / f64) to (0.85, 1.18), as tests/test_bf16_trajectory.py:112 does.
At batch 2 the ASPP's pooling branch normalizes two values a channel
(`head.global_pooling_bn` sees the (2, C, 1, 1) global pool): its output
is +-|a - b| / sqrt((a - b)^2 + 4 eps) and its gradient scales as
1 / sqrt((a - b)^2 + 4 eps), so a channel whose two bf16 values lie within
a few units of rounding of each other takes a sign or a scale from the
rounding alone. That gradient reaches `global_pooling_conv` and, through
the global average pool, the whole body.

This file cuts that branch's backward path, by zeroing
`head.pool_red_conv`'s weight in the start state (the branch then adds 0 to
the map and passes no gradient back), and holds both packages' bf16
steps to the JAX band against float64 from the same start. Without the
cut it holds the tensors off that path (the ASPP map branches, the
reduction, the classifiers and `pool_red_conv` itself) to the band, and
prints every group's update norm for the port's bf16, the JAX bf16 and
the float64 steps, with the count of the pooling norm's channels that
hang on one rounding. The float64 steps of the two packages agree
throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import test_torch_bf16_trajectory as T
from ucd_torch.engine import build_train_state, make_train_step
from ucd_torch.models import make_model
from ucd_torch.models.convert import state_dict_to_flax
from ucd_tpu import config as JC
from ucd_tpu.engine import build_train_state as jax_build_train_state
from ucd_tpu.engine import make_train_step as jax_make_train_step
from ucd_tpu.models import make_model as jax_make_model

pytestmark = pytest.mark.slow

CUT = "head.pool_red_conv.weight"
# the tensors whose gradient does not pass the pooling norm
OFF_PATH = ("params/head/map_", "params/head/red_", "params/cls_",
            "params/head/pool_red_conv/")


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _norm(update, keys=None) -> float:
    keys = update if keys is None else keys
    return float(np.sqrt(sum(np.sum(update[k] ** 2) for k in keys)))


def _wide(model) -> dict:
    return state_dict_to_flax({k: v.double()
                               for k, v in model.state_dict().items()})


def port_step(dtype, bf16_norm, model_sd, donor_sd, batch) -> tuple:
    """One port step at `dtype` from `model_sd` with `donor_sd` as the
    donor: (loss_tot, each parameter's update, the pooling norm's input)."""
    cast = (lambda v: v.to(torch.float64) if v.is_floating_point()
            else v) if dtype == "float64" else (lambda v: v)
    _, cfg = T._configs(dtype, bf16_norm)
    model_old = make_model(cfg, classes=cfg.classes_per_step[:-1])
    model = make_model(cfg)
    state, old_vars = build_train_state(
        cfg, model, torch.Generator().manual_seed(1), total_iters=T.N_STEPS,
        prev_model_state={k: cast(v) for k, v in donor_sd.items()},
        device="cpu")
    model.load_state_dict({k: cast(v) for k, v in model_sd.items()})
    seen = []
    hook = model.head.global_pooling_bn.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].detach().double()))
    step = make_train_step(cfg, model, model_old, total_iters=T.N_STEPS,
                           device="cpu")
    before = _wide(model)
    _, m = step(state, batch, old_vars)
    hook.remove()
    after = _wide(model)
    return (float(m["loss_tot"]),
            {k: after[k] - before[k] for k in before
             if k.startswith("params/")}, seen[0])


def _tree(flat, collection, dtype):
    return unflatten_dict({k[len(collection) + 1:]: jnp.asarray(v, dtype)
                           for k, v in flat.items()
                           if k.startswith(collection + "/")}, sep="/")


class JaxStep:
    """One JAX step at `dtype` from a given start (ucd_tpu.engine), the
    donor and the jitted step built once; call it before another JaxStep
    is built."""

    def __init__(self, dtype, bf16_norm, donor_flat):
        self.wide = jnp.float64 if dtype == "float64" else jnp.float32
        cfg = JC.make_config(
            dataset="voc", task="19-1", step=1, method="UCD",
            backbone="resnet50", crop_size=T.SIZE, batch_size=T.B,
            dtype=dtype, contrastive_capacity=128,
            use_pallas_contrastive=False, fused_loss=False,
            bf16_norm=bf16_norm)
        model_old = jax_make_model(cfg, classes=cfg.classes_per_step[:-1])
        model = jax_make_model(cfg)
        prev = {c: _tree(donor_flat, c, self.wide)
                for c in ("params", "batch_stats")}
        self.state, self.old_vars = jax_build_train_state(
            cfg, model, jax.random.key(1), total_iters=T.N_STEPS,
            prev_model_state=prev, input_shape=(1, T.SIZE, T.SIZE, 3))
        self.step = jax.jit(jax_make_train_step(cfg, model, model_old,
                                                total_iters=T.N_STEPS))

    def __call__(self, model_flat, batch):
        state = self.state.replace(
            params=_tree(model_flat, "params", self.wide),
            batch_stats=_tree(model_flat, "batch_stats", self.wide))
        flat = lambda p: {"params/" + k: np.asarray(v, np.float64)
                          for k, v in flatten_dict(p, sep="/").items()}
        before = flat(state.params)
        state, m = self.step(state, {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                             self.old_vars)
        after = flat(state.params)
        return float(m["loss_tot"]), {k: after[k] - before[k]
                                      for k in before}


def _group(key: str) -> str:
    path = key.split("/")[1:]
    return "/".join(path[:2]) if path[0] in ("head", "body") else path[0]


def _near_ties(pool_in, pool_in_64) -> tuple:
    """The pooling norm's channels whose two values (a batch of 2) differ
    by at most 4 bf16 units of rounding in the bf16 step, and those of them
    whose difference takes another sign at float64."""
    a, b = pool_in.reshape(2, -1)
    d64 = (lambda v: v[0] - v[1])(pool_in_64.reshape(2, -1))
    ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(a.abs(), b.abs())
    near = (a - b).abs() <= 4 * ulp
    flipped = near & (torch.sign(a - b) != torch.sign(d64))
    return int(near.sum()), int(flipped.sum()), int(a.numel())


@pytest.mark.parametrize("bf16_norm", [False, True],
                         ids=["plain", "bf16_norm"])
def test_bf16_step_gap_sits_on_the_pooling_norm(rng, bf16_norm, x64):
    img = rng.randn(T.B, T.SIZE, T.SIZE, 3).astype(np.float32)
    lab = rng.randint(0, 21, size=(T.B, T.SIZE, T.SIZE)).astype(np.int32)
    batch = {"image": img, "label": lab}
    # the trajectory test's start: its bf16 run's seeded weights and donor
    _, _, (model_sd, donor_sd) = T._trajectory("bfloat16", [batch],
                                               bf16_norm)
    cut_sd = {k: torch.zeros_like(v) if k == CUT else v
              for k, v in model_sd.items()}
    donor_flat = state_dict_to_flax(donor_sd)
    starts = {"uncut": model_sd, "cut": cut_sd}
    runs, pool_in = {name: {} for name in starts}, {}
    for name, sd in starts.items():
        for side, dtype, norm in (("port_bf16", "bfloat16", bf16_norm),
                                  ("port_f64", "float64", False)):
            loss, update, seen = port_step(dtype, norm, sd, donor_sd, batch)
            runs[name][side] = (loss, update)
            pool_in[name, side] = seen
    # one JAX dtype at a time: ucd_tpu's make_model sets the norm dtype
    # that the step reads when it is traced (its first call)
    for side, dtype, norm in (("jax_bf16", "bfloat16", bf16_norm),
                              ("jax_f64", "float64", False)):
        step = JaxStep(dtype, norm, donor_flat)
        for name, sd in starts.items():
            runs[name][side] = step(state_dict_to_flax(sd), batch)

    near, flipped, channels = _near_ties(pool_in["uncut", "port_bf16"],
                                         pool_in["uncut", "port_f64"])
    print(f"BF16_STEP bf16_norm={bf16_norm}: {near} of {channels} pooling "
          f"norm channels within 4 bf16 units of rounding, {flipped} of "
          "them of another sign at float64")
    for name, r in runs.items():
        n64 = _norm(r["port_f64"][1])
        print(f"BF16_STEP {name}: loss " + ", ".join(
            f"{side} {loss:.6f}" for side, (loss, _) in r.items())
            + "; update-norm ratio port "
            f"{_norm(r['port_bf16'][1]) / n64:.4f}, jax "
            f"{_norm(r['jax_bf16'][1]) / _norm(r['jax_f64'][1]):.4f}")
        ref = r["port_f64"][1]
        for g in sorted({_group(k) for k in ref}):
            keys = [k for k in ref if _group(k) == g]
            print(f"  {g:24s} f64 {_norm(ref, keys):.4e} port_bf16 "
                  f"{_norm(r['port_bf16'][1], keys):.4e} jax_bf16 "
                  f"{_norm(r['jax_bf16'][1], keys):.4e}")

    for name, r in runs.items():
        # the two packages' float64 steps are one step
        (l_p, u_p), (l_j, u_j) = r["port_f64"], r["jax_f64"]
        assert abs(l_p - l_j) <= 1e-6 * abs(l_j), (name, l_p, l_j)
        diff = {k: u_p[k] - u_j[k] for k in u_j}
        assert _norm(diff) <= 1e-4 * _norm(u_j), (name, _norm(diff))

    # the branch cut: both packages' bf16 steps inside the JAX band
    cut = runs["cut"]
    for pkg in ("port", "jax"):
        (l_bf, u_bf), (l_64, u_64) = cut[f"{pkg}_bf16"], cut[f"{pkg}_f64"]
        rel, ratio = abs(l_bf - l_64) / abs(l_64), _norm(u_bf) / _norm(u_64)
        assert rel <= 0.02, (pkg, "cut", rel)
        assert 0.85 < ratio < 1.18, (pkg, "cut", ratio)

    # uncut: the port's tensors off the pooling norm's path in the band
    uncut = runs["uncut"]
    ref = uncut["port_f64"][1]
    off = [k for k in ref if k.startswith(OFF_PATH) and _norm(ref, [k]) > 0]
    assert any(k.startswith("params/head/map_") for k in off), off
    ratio = _norm(uncut["port_bf16"][1], off) / _norm(ref, off)
    assert 0.85 < ratio < 1.18, ("uncut, off the path", ratio)
