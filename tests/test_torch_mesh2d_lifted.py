"""Everything the JAX package runs on its 2-D data x model mesh, run by the
port on a 2 x 2 mesh of four gloo ranks (ResNet-18, 64x64 crops, float64,
global batch 2: one image a data rank, `min_size` 64, so that every body
and head width is sharded over the model axis) and held to the JAX
package's unchanged step on the global batch: the validate step,
`nan_guard`, the EWC / PI / RW regularizers, the execution options and
GroupNorm ABNs.

One spawn of four ranks runs every case in turn (tests/torch_mesh2d_workers.py
`cases_worker`) while this process computes the JAX references and checks
each case as soon as its files are written, then deletes them (the ranks
wait for that before the next case: one case's files and the float32 spec
file lie on disk, under 0.8 GB); one parametrised test reports each case.
Bounds, those of tests/test_torch_dp_step.py: loss terms rtol 2e-5 / atol
1e-9; per-leaf updates |e| <= 2e-4 |ref| + 3e-6 max|ref| and 1e-4 over
all; BatchNorm running statistics rtol 1e-6 / atol 1e-9; `cls_0` exactly
unchanged at step 1; the regularizers' accumulators |e| <= 1e-5 |ref| + 1e-12
(tests/test_torch_families.py); replicated tensors bit-equal across each
model group, shards across each data group. The cases:

  * validate_ft_step0, validate_ucd_step1 (with the donor): `make_eval_step`
    against the JAX `make_eval_step`: the confusion matrix exactly equal,
    its total the batch's labelled pixels (each counted once, not once a
    model rank), the predictions equal, the losses at the loss bound;
  * nan_guard_finite: FT step 0 under `nan_guard` against the JAX step
    under it; nan_guard_skipped: the same step with model rank 1's
    gradient of one sharded conv made NaN: every rank skips, its
    parameters, momentum and update count keep their bits, `nonfinite`
    counts 1, and the statistics and metrics are the finite step's;
  * ewc, pi, rw: one step-1 iteration from a seeded export against the
    JAX step, the body's parameters 1 % off their anchors, so that the
    penalty, summed over the shards, is > 0;
  * stem_s2d, remat, remat_early: FT step 0 against the JAX step with the
    option; the remat steps' bits equal the plain mesh step's (`plain`);
  * gn_even (16 groups: every shard holds whole groups) and gn_uneven (1
    group: each GroupNorm gathers its input and normalizes it whole):
    every ABN a GroupNorm ABN, against the JAX step with the JAX ABN's
    `norm_type="gn"`;
  * bf16_norm, bf16_norm_early: FT step 0 against the port's one-process
    step with the option under the bounds above, and against the JAX step
    with the option at tests/test_torch_exec_options.py's bf16 bound (the
    loss terms and the body's BatchNorm statistics, 5e-2). The JAX step is
    no tight reference at float64 there: flax's bf16 BatchNorm computes
    in f32 what the port computes in f64, and the two round to different
    bf16 values off the mesh too (the loss 1.4e-3 apart).
"""

import contextlib
import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_workers as W
import torch_mesh2d_workers as M
from test_torch_dp_step import start as step1_start
from test_torch_families import _reg_flat
from test_torch_mesh2d_step import assert_step_close
from test_torch_train_step import _batches, _cfgs, _flat_of, _tree
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import random_flat_variables
from ucd_torch.engine.state import (shard_state, unshard_reg_state,
                                    unshard_state)
from ucd_torch.models import flax_to_state_dict, state_dict_to_flax
from ucd_torch.ops.regularizers import RegState
from ucd_tpu import engine as JE
from ucd_tpu.models import layers as JL
from ucd_tpu.models import make_model as jax_make_model

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_DATA, N_MODEL, MIN_SIZE = 2, 2, 64
NAN_PARAM = "body.mod4_block1.conv1.weight"
STEP0 = {"plain": {}, "nan_guard_finite": {"nan_guard": True},
         "stem_s2d": {"stem_s2d": True}, "remat": {"remat": True},
         "remat_early": {"remat_early": True}}
GN = {"gn_even": 16, "gn_uneven": 1}
REG = ("ewc", "pi", "rw")
CASES = ("validate_ft_step0", "validate_ucd_step1", "nan_guard_finite",
         "nan_guard_skipped", *REG, "bf16_norm", "bf16_norm_early",
         "stem_s2d", "remat", "remat_early", *GN)


@contextlib.contextmanager
def jax_group_norm(groups):
    """The JAX model's ABNs built with `norm_type="gn"` and `groups`
    groups (the JAX ABN's own option), inside the block."""
    import ucd_tpu.models.deeplab as JD
    import ucd_tpu.models.resnet as JR

    saved = JR.ABN, JD.ABN
    JR.ABN = JD.ABN = functools.partial(JL.ABN, norm_type="gn",
                                        gn_groups=groups)
    try:
        yield
    finally:
        JR.ABN, JD.ABN = saved


def step0_start(kw):
    """FT at step 0 from one seeded tree (tests/test_torch_mesh2d_step.py's
    start) with the options `kw` on both sides: (spec, JAX cfg, model,
    state)."""
    from ucd_tpu.engine.train import TrainState

    cfg_t, cfg_j = _cfgs(0, "FT", "float64", **kw)
    cfg_j = dataclasses.replace(cfg_j, fused_loss=False,
                                use_pallas_contrastive=False)
    model_j = jax_make_model(cfg_j)
    flat = random_flat_variables(model_j, (W.SIZE, W.SIZE), seed=11)
    params = _tree(flat, "params", jnp.float64)
    state_j = TrainState(
        params=params, batch_stats=_tree(flat, "batch_stats", jnp.float64),
        opt_state=jax.jit(JE.make_optimizer(cfg_j, W.TOTAL_ITERS).init)(
            params),
        reg_state=None, step=jnp.zeros((), jnp.int32))
    spec = {"method": "FT", "step": 0, "flat0": None, "kw": kw,
            "before": _flat_of(state_j.params, state_j.batch_stats),
            "batches": _batches(1, cfg_t.tot_classes, seed=12)}
    return spec, cfg_j, model_j, state_j


def f32_valued(x):
    """`x` rounded to float32 values, kept in its dtype."""
    return x.astype(np.float32).astype(x.dtype)


def reg_start(kind):
    """VOC 15-5s step 1 under `kind` (EWC / PI / RW) from a seeded export
    (tests/test_torch_dp_step.py's start), with the body's parameters
    moved off their anchors, the donor's, as after some iterations: one
    step's penalty is then > 0. (spec, JAX cfg, model, donor model, state,
    donor variables)."""
    from test_torch_families import _saved_reg
    from ucd_tpu.ops import regularizers as JR

    spec, cfg_j, model_j, model0_j, state_j, old_j = step1_start(
        kind.upper(), reg_seed=5)
    rs = np.random.RandomState(6)
    # float32 values in float64 arrays (as every other start's), so that
    # the ranks' spec file holds them in half the bytes
    before = {k: f32_valued(v + 0.01 * np.abs(v).mean() * rs.randn(*v.shape))
              if k.startswith("params/body/") else v
              for k, v in spec["before"].items()}
    saved_j, _ = _saved_reg(cfg_j, spec["flat0"], 5)
    saved_j = jax.tree.map(lambda x: jnp.asarray(f32_valued(np.asarray(x))),
                           saved_j)
    spec["saved"] = {f: {k: v.float().double() for k, v in tree.items()}
                     for f, tree in spec["saved"].items()}
    params = _tree(before, "params", jnp.float64)
    reg = jax.jit(lambda p, o, sv: JR.init_reg_state(
        cfg_j.regularizer, p, old_params=o, saved=sv, alpha=cfg_j.reg_alpha,
        iterations=cfg_j.reg_iterations, normalize=cfg_j.reg_normalize))(
            params, old_j["params"], saved_j)
    state_j = state_j.replace(
        params=params, reg_state=reg,
        opt_state=jax.jit(JE.make_optimizer(cfg_j, W.TOTAL_ITERS).init)(
            params))
    return ({**spec, "before": before}, cfg_j, model_j, model0_j, state_j,
            old_j)


def jax_steps(cfg_j, model_j, model0_j, state_j, old_j, batches):
    """The JAX train step over `batches`: (variables after, the last
    metrics, the regularizer state)."""
    step_j = jax.jit(JE.make_train_step(cfg_j, model_j, model0_j,
                                        total_iters=W.TOTAL_ITERS))
    for b in batches:
        state_j, m_j = step_j(state_j, {k: jnp.asarray(v)
                                        for k, v in b.items()}, old_j)
    return (_flat_of(state_j.params, state_j.batch_stats),
            {k: float(v) for k, v in m_j.items()}, state_j.reg_state)


def jax_eval(cfg_j, model_j, model0_j, state_j, old_j, batch):
    """The JAX validate step on the global batch: (confusion matrix,
    losses, predictions)."""
    eval_j = jax.jit(JE.make_eval_step(cfg_j, model_j, model0_j))
    hist, m, preds = eval_j(
        {"params": state_j.params, "batch_stats": state_j.batch_stats},
        {k: jnp.asarray(v) for k, v in batch.items()},
        JE.empty_confusion(cfg_j.tot_classes), old_j)
    return (np.asarray(hist), {k: float(v) for k, v in m.items()},
            np.asarray(preds))


def one_process(spec):
    """The port's one-process step on the global batch."""
    _, model, state, old, step = M.build(spec)
    state, m = step(state, spec["batches"][0], old)
    return W.snapshot(model, state, m)


@contextlib.contextmanager
def jax_norm_dtype(dtype):
    """The JAX ABNs' process-wide norm dtype (read when a step is traced)
    set to `dtype` inside the block."""
    saved = JL.DEFAULT_NORM_DTYPE[0]
    JL.DEFAULT_NORM_DTYPE[0] = dtype
    try:
        yield
    finally:
        JL.DEFAULT_NORM_DTYPE[0] = saved


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case's outcome by name: None where its checks passed, else
    the error they raised. The ranks run while this process computes the
    JAX references, and each case is checked, and its files deleted, as
    soon as its reference and the four ranks' files are there."""
    tmp = tmp_path_factory.mktemp("lifted")
    prev_x64 = jax.config.jax_enable_x64
    norm_defaults = JL.DEFAULT_NORM_DTYPE[0], JL.DEFAULT_FAST_VARIANCE[0]
    threads = torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)
    try:
        outcomes = _run_cases(tmp)
    finally:
        jax.config.update("jax_enable_x64", prev_x64)
        JL.DEFAULT_NORM_DTYPE[0], JL.DEFAULT_FAST_VARIANCE[0] = \
            norm_defaults
        torch.set_num_threads(threads)
    yield outcomes
    shutil.rmtree(tmp, ignore_errors=True)


def unsharded_snapshot(ranks, like):
    """The variables after the step, as a `snapshot`: data row 0's shards
    at the start (`like`, the full state dict, cut by `shard_state`) plus
    their change, put back together."""
    by_place = {r["place"]: r for r in ranks}
    shards = []
    for m in range(N_MODEL):
        start = shard_state(like, N_MODEL, m, MIN_SIZE)
        delta = by_place[(0, m)]["delta"]
        shards.append({k: start[k] + delta[k].to(start[k].dtype)
                       if start[k].is_floating_point() else delta[k]
                       for k in delta})
    full = unshard_state(shards, like, MIN_SIZE)
    return {"vars": {k: np.asarray(v, np.float64) for k, v in
                     state_dict_to_flax(full).items()},
            "metrics": ranks[0]["metrics"]}


def _specs_and_starts():
    """Every case's spec (what the ranks run) and its start (what the
    JAX reference runs from), by name, in the ranks' order."""
    starts, specs = {}, {}
    # the JAX models' norm defaults are process-wide and read when a step
    # is traced: every JAX model here is built without a bf16 norm
    for name, kw in STEP0.items():
        starts[name] = step0_start(kw)
        specs[name] = starts[name][0]
    specs["nan_guard_skipped"] = {**specs["nan_guard_finite"],
                                  "nan": (1, NAN_PARAM)}
    for name, kw in (("bf16_norm", {"bf16_norm": True}),
                     ("bf16_norm_early", {})):
        specs[name] = {**specs["plain"], "kw": kw,
                       "early_bf16": name == "bf16_norm_early"}
    for name, groups in GN.items():
        with jax_group_norm(groups):
            starts[name] = step0_start({})
        specs[name] = {**starts[name][0], "gn": groups}
    for kind in REG:
        starts[kind] = reg_start(kind)
        specs[kind] = {**starts[kind][0], "step": 1, "kw": {}}
    spec, cfg_j, model_j, state_j = starts["plain"]
    starts["validate_ft_step0"] = (spec, cfg_j, model_j, None, state_j,
                                   None)
    specs["validate_ft_step0"] = {**spec, "eval": True}
    spec, *rest = step1_start("UCD")
    starts["validate_ucd_step1"] = (spec, *rest)
    specs["validate_ucd_step1"] = {**spec, "step": 1, "kw": {},
                                   "eval": True}
    return {name: specs[name] for name in ("plain",) + CASES}, starts


def _reference(name, specs, starts):
    """Case `name`'s reference: the JAX step (validate: the JAX validate
    step) on the global batch; for the bf16-norm cases also the port's
    one-process step."""
    if name in ("plain", "nan_guard_skipped"):
        return None
    if name.startswith("bf16_norm"):
        # the JAX step from the plain start, its ABNs rounding as the
        # option makes them (the early ones only under the bf16 policy
        # in make_model: set on the module here)
        _, cfg_j, model_j, state_j = starts["plain"]
        if name == "bf16_norm_early":
            model_j = model_j.clone(norm_dtype_early=jnp.bfloat16)
        with (jax_norm_dtype(jnp.bfloat16) if name == "bf16_norm"
              else contextlib.nullcontext()):
            ref_j = jax_steps(cfg_j, model_j, None, state_j, None,
                              specs[name]["batches"])
        return one_process(specs[name]), ref_j
    if name.startswith("validate"):
        spec, cfg_j, model_j, model0_j, state_j, old_j = starts[name]
        return jax_eval(cfg_j, model_j, model0_j, state_j, old_j,
                        spec["batches"][0])
    if name in REG:
        spec, cfg_j, model_j, model0_j, state_j, old_j = starts[name]
        return jax_steps(cfg_j, model_j, model0_j, state_j, old_j,
                         spec["batches"])
    _, cfg_j, model_j, state_j = starts[name]
    with (jax_group_norm(GN[name]) if name in GN
          else contextlib.nullcontext()):
        return jax_steps(cfg_j, model_j, None, state_j, None,
                         specs[name]["batches"])


def _run_cases(tmp):
    specs, starts = _specs_and_starts()
    # the ranks' file names each set of variables and each export tree
    # once, in float32, which holds each of their values
    variables, cases = {}, {}

    def key_of(tree, k):
        """The key of the stored tree equal to `tree`, else `k`, under
        which `tree` is then stored."""
        tree = {n: np.asarray(v) for n, v in tree.items()}
        for old in sorted(variables, key=lambda o: o != k):
            t = variables[old]
            if t.keys() == tree.keys() and all(
                    np.array_equal(t[n], v) for n, v in tree.items()):
                return old
        assert k not in variables, k
        assert all(np.array_equal(f32_valued(v), v) for v in tree.values())
        variables[k] = {n: v.astype(np.float32) for n, v in tree.items()}
        return k

    for name, spec in specs.items():
        key = "step%d" % spec["step"]
        keys = {"before": key_of(spec["before"], "gn%d" % spec["gn"]
                                 if spec.get("gn") else key + (
                                     "_reg" if spec.get("saved") else ""))}
        if spec["flat0"] is not None:
            keys["flat0"] = key_of(spec["flat0"], key + "_prev")
        if spec.get("saved"):
            keys["saved"] = {f: key_of(tree, f"{name}_{f}")
                             for f, tree in spec["saved"].items()}
        cases[name] = {**spec, "flat0": None, **keys}
    torch.save(W.as_tensors({"vars": variables, "cases": cases}),
               tmp / "specs.pt")
    ranks = W.start_ranks(M.cases_worker, N_DATA * N_MODEL, tmp,
                          str(tmp / "specs.pt"), str(tmp), N_DATA, N_MODEL,
                          MIN_SIZE)
    names = list(specs)
    refs, outcomes, light = {}, {}, {}

    def drain():
        """Check each case, in the ranks' order, whose reference and four
        files are there; keep the small part of its results (no step
        change, no regularizer trees) for the later cases that read it,
        and delete its files."""
        while len(outcomes) < len(names):
            name = names[len(outcomes)]
            paths = [tmp / f"{name}{r}.pt" for r in range(N_DATA * N_MODEL)]
            if name not in refs or not all(p.exists() for p in paths):
                return
            got = [torch.load(p, weights_only=False) for p in paths]
            try:
                check_case(name, specs[name], refs[name], got, light)
                outcomes[name] = None
            except Exception as e:  # reported by the case's own test
                outcomes[name] = e
            light[name] = [{k: v for k, v in r.items()
                            if k not in ("delta", "reg")} for r in got]
            for p in paths:
                p.unlink()

    try:
        for name in names:
            refs[name] = _reference(name, specs, starts)
            drain()
        while not ranks.join(timeout=0.5):
            drain()
        drain()
    except BaseException:
        for p in ranks.processes:
            p.kill()
        raise
    finally:
        (tmp / "specs.pt").unlink()
    assert len(outcomes) == len(names), sorted(outcomes)
    return outcomes


def _check_validate(spec, ref, ranks):
    hist_j, m_j, preds_j = ref
    labels = spec["batches"][0]["label"]
    n = hist_j.shape[0]
    labelled = int(((labels >= 0) & (labels < n)).sum())
    per_rank = labels.shape[0] // N_DATA
    for r in ranks:
        hist = r["hist"].numpy()
        # every pixel once: the data group's sum, not the world's
        assert int(hist.sum()) == labelled, (int(hist.sum()), labelled)
        np.testing.assert_array_equal(hist, hist_j)
        d, _ = r["place"]
        np.testing.assert_array_equal(
            r["preds"].numpy(), preds_j[d * per_rank:(d + 1) * per_rank])
        assert r["losses"] == ranks[0]["losses"]
        for k in ("loss", "lkd", "lde"):
            np.testing.assert_allclose(r["losses"][k], m_j[k], rtol=2e-5,
                                       atol=1e-9, err_msg=k)


def _unsharded_reg(ranks, like):
    """The regularizer state of data row 0's model group, put back
    together."""
    by_place = {r["place"]: r for r in ranks}
    states = []
    for m in range(N_MODEL):
        reg = dict(by_place[(0, m)]["reg"])
        states.append(RegState(kind=reg.pop("kind"),
                               count=torch.tensor(reg.pop("count")), **reg))
    return unshard_reg_state(states, like, MIN_SIZE)


def _check_reg(spec, ref, ranks, like):
    _, _, reg_j = ref
    assert ranks[0]["metrics"]["l_reg"] > 0
    full = _unsharded_reg(ranks, like)
    assert int(full.count) == int(reg_j.count)
    for field in W.REG_FIELDS:
        a, b = _reg_flat(full, field, False), _reg_flat(reg_j, field, True)
        assert (a is None) == (b is None), field
        if a is None:
            continue
        assert set(a) == set(b), field
        for k in b:
            err = float(np.linalg.norm(a[k] - b[k]))
            ref_n = float(np.linalg.norm(b[k]))
            assert err <= 1e-5 * ref_n + 1e-12, (field, k, err, ref_n)


def check_bits_across_ranks(ranks):
    """Replicated tensors bit-equal across each model group, shards
    across each data group (by digest); the metrics equal everywhere."""
    by_place = {r["place"]: r for r in ranks}
    sharded = set(ranks[0]["sharded"])
    for r in ranks:
        assert r["sharded"] == ranks[0]["sharded"]
        assert r["metrics"] == ranks[0]["metrics"]
        d, m = r["place"]
        for what, tensors in r["digests"].items():
            for k, v in tensors.items():
                other = by_place[(d, 0)] if k not in sharded \
                    else by_place[(0, m)]
                assert v == other["digests"][what][k], (r["place"], what, k)
    return by_place


def _check_skipped(ranks, finite, like):
    params = {k for k in like if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))}
    fin = {r["place"]: r for r in finite}
    for r in ranks:
        assert r["nonfinite"] == 1 and r["count"] == 0, r["place"]
        assert r["metrics"] == fin[r["place"]]["metrics"]
        for k, v in r["digests"]["sd"].items():
            want = r["before"][k] if k in params \
                else fin[r["place"]]["digests"]["sd"][k]
            assert v == want, (r["place"], k)
        assert r["trace_zero"]
    assert all(r["nonfinite"] == 0 and r["count"] == 1 for r in finite)


def _check_bf16_against_jax(got, ref_j):
    """The bf16-norm step against the JAX step with the option at
    tests/test_torch_exec_options.py's bf16 bound, 5e-2: the loss terms
    (relative) and the body's BatchNorm statistics (of max|ref|), where
    the forward's rounding shows. The update is not compared: the two
    round different values to bf16 and their updates differ by about
    their size (0.8 of it under bf16_norm, 0.4 under bf16_norm_early,
    off the mesh too)."""
    after_j, m_j, _ = ref_j
    for key in W.TERMS:
        np.testing.assert_allclose(got["metrics"][key], m_j[key],
                                   rtol=5e-2, atol=1e-9, err_msg=key)
    for k, ref in after_j.items():
        if k.startswith("batch_stats/body/"):
            err = np.abs(got["vars"][k] - ref).max()
            assert err <= 5e-2 * np.abs(ref).max(), (k, err)


def check_case(case, spec, ref, ranks, light):
    """Case `case`'s checks on the four ranks' results, against its
    reference; `light` holds the earlier cases' results without their
    step change and regularizer trees."""
    if case == "plain":
        return
    if spec.get("eval"):
        _check_validate(spec, ref, ranks)
        return
    like = flax_to_state_dict(spec["before"])
    by_place = check_bits_across_ranks(ranks)
    sharded = set(ranks[0]["sharded"])
    norm = "gn" if spec.get("gn") else "bn"
    assert NAN_PARAM in sharded and f"head.map_bn.{norm}.weight" in sharded
    if case == "nan_guard_skipped":
        _check_skipped(ranks, light["nan_guard_finite"], like)
        return
    got = unsharded_snapshot(ranks, like)
    frozen = "params/cls_0/" if spec["step"] else None
    if case.startswith("bf16"):
        one, ref_j = ref
        _check_bf16_against_jax(got, ref_j)
        after_j, m_j = one["vars"], one["metrics"]
    else:
        after_j, m_j = ref[:2]
    assert_step_close(got, spec["before"], after_j, m_j, frozen,
                      f"2 x 2 mesh, {case}")
    if case in REG:
        _check_reg(spec, ref, ranks, like)
    if case.startswith("remat"):
        plain = {r["place"]: r for r in light["plain"]}
        for place, r in by_place.items():
            assert r["metrics"] == plain[place]["metrics"]
            assert r["digests"] == plain[place]["digests"], place
    if case == "nan_guard_finite":
        assert all(r["nonfinite"] == 0 and r["count"] == 1 for r in ranks)


@pytest.mark.parametrize("case", CASES)
def test_the_2x2_mesh_runs_what_it_refused(case, results):
    """Case `case` passed its checks (`check_case`), made as soon as its
    files were written."""
    error = results[case]
    if error is not None:
        raise error
