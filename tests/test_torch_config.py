"""ucd_torch.config / ucd_torch.tasks are the port's own copies: they agree
with ucd_tpu.config / ucd_tpu.tasks field by field, preset by preset and
over the whole task registry (exact equality; nothing is computed in
floating point)."""

import dataclasses

import pytest

from ucd_torch import config as TC
from ucd_torch import tasks as TT
from ucd_tpu import config as JC
from ucd_tpu import tasks as JT

TASKS = [("voc", "19-1", 1), ("voc", "15-5s", 0), ("voc", "15-5s", 3),
         ("ade", "100-50", 1), ("city", "13-6s", 2)]


def test_fields_and_defaults_match():
    assert dataclasses.asdict(TC.Config()) == dataclasses.asdict(JC.Config())
    assert [f.name for f in dataclasses.fields(TC.Config)] and \
        {f.name for f in dataclasses.fields(TC.Config)} == \
        {f.name for f in dataclasses.fields(JC.Config)}
    assert TC.METHODS == JC.METHODS and TC.NUM_CLASSES == JC.NUM_CLASSES


@pytest.mark.parametrize("method", JC.METHODS)
def test_method_presets_match(method):
    for dataset, task, step in TASKS:
        kw = dict(dataset=dataset, task=task, step=step, method=method)
        if method in ("UCD",):
            kw["bug_compatible"] = False
        t, j = TC.make_config(**kw), JC.make_config(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), kw
        for prop in ("num_classes", "classes_per_step", "tot_classes",
                     "old_classes", "new_classes", "task_name"):
            assert getattr(t, prop) == getattr(j, prop), (kw, prop)
        assert t.ckpt_path() == j.ckpt_path()
        assert t.resolve_pretrained_path() == j.resolve_pretrained_path()


def test_bug_compatible_and_city_domain_match():
    for kw in (dict(dataset="voc", task="15-5s", step=1, method="MiB",
                    bug_compatible=True),
               dict(dataset="voc", task="19-1", step=0, method="FT",
                    bug_compatible=True),
               dict(dataset="city_domain", task="11-10", step=1,
                    method="LWF")):
        if kw["dataset"] == "city_domain":
            kw["task"] = sorted(JT.TASKS_CITY_DOMAIN)[0]
        t, j = TC.make_config(**kw), JC.make_config(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), kw
        assert t.classes_per_step == j.classes_per_step


def test_validation_rejects_the_same_configs():
    for kw in (dict(backbone="resnet18"), dict(output_stride=4),
               dict(dataset="voc", task="19-1", step=7),
               dict(dataset="city_domain",
                    task=sorted(JT.TASKS_CITY_DOMAIN)[0], method="MiB")):
        with pytest.raises(AssertionError):
            JC.make_config(**kw)
        with pytest.raises(AssertionError):
            TC.make_config(**kw)
    kw = dict(contrastive=True, contrastive_bug_compatible=True)
    with pytest.raises(ValueError):
        JC.make_config(**kw)
    with pytest.raises(ValueError):
        TC.make_config(**kw)


def test_poly_lr_matches():
    for it in (0, 1, 17, 99, 100):
        assert TC.poly_lr(0.007, it, 100) == JC.poly_lr(0.007, it, 100)


def test_task_registry_matches_everywhere():
    assert TT.get_task_list() == JT.get_task_list()
    n = 0
    for dataset, table in (("voc", JT.TASKS_VOC), ("ade", JT.TASKS_ADE),
                           ("city", JT.TASKS_CITY),
                           ("city_domain", JT.TASKS_CITY_DOMAIN)):
        for name, steps in table.items():
            assert TT.get_task_dict(dataset, name) == steps
            assert TT.num_steps(dataset, name) == JT.num_steps(dataset, name)
            for step in steps:
                assert TT.get_per_task_classes(dataset, name, step) == \
                    JT.get_per_task_classes(dataset, name, step)
                assert TT.get_task_labels(dataset, name, step) == \
                    JT.get_task_labels(dataset, name, step)
                n += 1
    assert n > 50


def test_tpu_only_fields_are_reported():
    """The one field that steers the JAX package's TPU backend
    (`xla_options`) stays in the Config and a non-default value is reported
    (the train step raises on it). `steps_per_call` is the port's own (K
    steps a CUDA-graph call); the model's execution options are ported and
    `data_axis` is accepted and ignored, as in the JAX package."""
    assert TC.unsupported_fields(TC.Config()) == []
    assert TC.TPU_ONLY_DEFAULTS == {"xla_options": ""}
    cfg = TC.Config(remat=True, steps_per_call=4, xla_options="a=b")
    assert sorted(TC.unsupported_fields(cfg)) == ["xla_options"]
    assert TC.unsupported_fields(TC.Config(
        steps_per_call=4, remat=True, remat_early=True, stem_s2d=True,
        bf16_norm=True, bf16_norm_early=True, data_axis=2)) == []
