"""The pretrained backbone body: the port's loaders against the JAX
package's on a seeded body written by JAX `save_body_npz` and on a seeded
inplace-abn-keyed `.pth.tar` release file, the npz sibling rule, and the
missing-file error of `Experiment` (the JAX package's text)."""

import os

import numpy as np
import pytest
import torch

from ucd_torch import config as TC
from ucd_torch.data import SyntheticSegmentation
from ucd_torch.engine.experiment import Experiment
from ucd_torch.models import (IncrementalSegmentationModel,
                              flax_to_state_dict, state_dict_to_flax)
from ucd_torch.models import pretrained as TP
from ucd_tpu.models import pretrained as JP


def _release_key(name):
    """A `model.body` state_dict name -> the inplace-abn release key."""
    mod, rest = name.split(".", 1)
    if mod.startswith("mod1_"):
        return "mod1." + mod[len("mod1_"):] + "." + rest.replace("bn.", "")
    stage, block = mod.split("_")
    sub, leaf = rest.split(".", 1)
    leaf = leaf.replace("bn.", "")
    if sub.startswith("proj_"):
        return f"{stage}.{block}.{sub}.{leaf}"
    return f"{stage}.{block}.convs.{sub}.{leaf}"


def _seeded_release(backbone, seed):
    body = IncrementalSegmentationModel((2,), backbone=backbone).body
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in body.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd["module." + _release_key(k)] = torch.tensor(7)
        else:
            sd["module." + _release_key(k)] = torch.randn(v.shape,
                                                          generator=g)
    sd["module.classifier.fc.weight"] = torch.randn(3, 4, generator=g)
    return body, sd


def _flat(tree):
    return {f"{c}/{k}": v for c in ("params", "batch_stats")
            for k, v in JP._flatten(tree[c]).items()}


@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
def test_release_file_loads_as_in_jax(tmp_path, backbone):
    body, sd = _seeded_release(backbone, seed=1)
    path = str(tmp_path / f"{backbone}_iabn_sync.pth.tar")
    torch.save({"state_dict": sd, "epoch": 90}, path)
    got = TP.load_pretrained_body(path)
    want = flax_to_state_dict(_flat(JP.load_pretrained_body(path)))
    assert set(got) == set(want) == set(body.state_dict())
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    assert all(int(v) == 0 for k, v in got.items()
               if k.endswith("num_batches_tracked"))
    body.load_state_dict(got, strict=True)
    # an npz sibling (the JAX package's converted format) is taken first
    body2, sd2 = _seeded_release(backbone, seed=2)
    del body2
    JP.save_body_npz(JP.convert_torch_body(
        {k: v.numpy() for k, v in sd2.items()}),
        path[:-len(".pth.tar")] + ".npz")
    got2 = TP.load_pretrained_body(path)
    want2 = flax_to_state_dict(_flat(JP.load_pretrained_body(path)))
    assert all(torch.equal(got2[k], want2[k]) for k in want2)
    assert not torch.equal(got2["mod1_conv1.weight"],
                           got["mod1_conv1.weight"])


def test_npz_body_and_missing_files(tmp_path):
    rs = np.random.RandomState(3)
    body = IncrementalSegmentationModel((2,), backbone="resnet18").body
    flat = state_dict_to_flax(
        {k: torch.from_numpy(rs.randn(*v.shape).astype(np.float32))
         for k, v in body.state_dict().items()
         if not k.endswith("num_batches_tracked")})
    tree = JP._unflatten(flat)
    path = str(tmp_path / "body.npz")
    JP.save_body_npz(tree, path)
    got = TP.load_pretrained_body(path)
    want = flax_to_state_dict(_flat(JP.load_body_npz(path)))
    assert set(got) == set(want) == set(body.state_dict())
    assert all(torch.equal(got[k], want[k]) for k in want)
    for missing in ("none.npz", "none.pth.tar", "none.pth"):
        p = str(tmp_path / missing)
        assert TP.load_pretrained_body(p) is None
        assert JP.load_pretrained_body(p) is None
    assert TP.strip_module_prefix({"module.a": 1, "classifier.b": 2,
                                   "c": 3}) == \
        JP.strip_module_prefix({"module.a": 1, "classifier.b": 2, "c": 3})


def _cfg(tmp_path, M, **kw):
    return M.make_config(dataset="voc", task="19-1", step=0,
                         backbone="resnet50", crop_size=32, batch_size=4,
                         dtype="float32", epochs=1,
                         logdir=str(tmp_path / "logs"),
                         ckpt_dir=str(tmp_path / "ck"), **kw)


def test_experiment_takes_the_body_and_names_a_missing_file(tmp_path):
    from ucd_tpu import config as JC
    from ucd_tpu.engine.experiment import Experiment as JExperiment
    bases = (SyntheticSegmentation(n=8, size=32, n_classes=20, seed=0),
             SyntheticSegmentation(n=4, size=32, n_classes=20, seed=1))
    body, sd = _seeded_release("resnet50", seed=4)
    path = str(tmp_path / "r50.pth.tar")
    torch.save(sd, path)
    exp = Experiment(_cfg(tmp_path, TC, pretrained_path=path), *bases,
                     device="cpu")
    want = TP.load_pretrained_body(path)
    got = exp.model.body.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want
               if not k.endswith("num_batches_tracked"))
    exp.close()
    missing = str(tmp_path / "nothing" / "r50.pth.tar")
    errors = []
    for M, E, kw in ((TC, Experiment, {"device": "cpu"}),
                     (JC, JExperiment, {})):
        with pytest.raises(FileNotFoundError) as e:
            E(_cfg(tmp_path, M, pretrained_path=missing), *bases, **kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "--no_pretrained" in errors[0]
    assert not os.path.exists(tmp_path / "ck")
