"""The port's command line against the JAX package's: the same option
strings (plus `--device`), the same `Config` from the same argv, the
refused flags, a two-step `run-task --device cpu` on synthetic data, then
`export` and `predict --save_ids` from its checkpoint, and the per-step
report."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from ucd_torch import cli as TCLI
from ucd_torch import config as TC
from ucd_torch.engine.export import load_inference
from ucd_torch.engine.predictor import Predictor
from ucd_torch.utils import reporting as TR
from ucd_tpu import cli as JCLI
from ucd_tpu.utils import reporting as JR


def _options(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, type(parser._subparsers._group_actions[0])))
    return {name: set(sp._option_string_actions)
            for name, sp in sub.choices.items()}


def test_option_strings_are_jax_plus_device():
    got, want = _options(TCLI.build_parser()), _options(JCLI.build_parser())
    assert set(got) == set(want) == {"train", "test", "run-task", "export",
                                     "predict", "serve"}
    for name in want:
        assert got[name] == want[name] | {"--device"}, (
            name, got[name] ^ (want[name] | {"--device"}))


ARGVS = [
    ["train", "--dataset", "voc", "--task", "15-5s", "--step", "1",
     "--method", "UCD", "--batch_size", "8", "--overlap"],
    ["run-task", "--dataset", "ade", "--task", "100-50", "--method", "MiB",
     "--crop_size", "256", "--opt_level", "O0", "--no_pallas",
     "--test_scales", "0.75,1.0", "--test_flip", "--fusion_mode", "max",
     "--crop_val", "--visualize", "--num_classes", "151", "--nan_guard",
     "--no_mask", "--cross_val", "--lr_policy", "step", "--auto_resume",
     "--async_ckpt", "--ckpt_dir", "ck", "--name", "n", "--epochs", "3"],
    ["test", "--dataset", "city", "--task", "13-6", "--step", "1",
     "--method", "LWF", "--backbone", "resnet50", "--output_stride", "8",
     "--no_pretrained", "--pretrained_path", "p.pth.tar", "--bug_compatible",
     "--no_fused_loss", "--no_device_normalize", "--step_ckpt", "s",
     "--fix_bn", "--freeze", "--loss_de", "2.5", "--alpha", "0.5",
     "--icarl_bkg", "--reg_no_normalize", "--test", "--sample_num", "2"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["train", "run-task", "test"])
def test_config_from_args_matches_jax(argv):
    t = TCLI.config_from_args(TCLI.build_parser().parse_args(argv))
    j = JCLI.config_from_args(JCLI.build_parser().parse_args(argv))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("extra,name", [
    (["--coordinator", "localhost:1234"], "--coordinator"),
    (["--num_processes", "2"], "--num_processes"),
    (["--process_id", "1"], "--process_id"),
    (["--distributed"], "--distributed"),
    (["--remat"], "--remat"),
    (["--xla_options", "a=1"], "--xla_options"),
    (["--steps_per_call", "2"], "--steps_per_call"),
])
def test_unported_flags_are_refused_by_name(tmp_path, extra, name):
    """The flag of a feature the port lacks (`--xla_options`, the JAX
    package's TPU compiler options) is refused by name; `--steps_per_call`,
    ported with the CUDA-graph bundle, the multi-process launch flags,
    ported with data parallelism (ucd_torch/parallel), and `--remat`,
    ported with the model's execution options, are taken."""
    argv = ["train", "--synthetic", "4", "--device", "cpu",
            "--ckpt_dir", str(tmp_path / "ck"), "--logdir",
            str(tmp_path / "logs")] + extra
    if name != "--xla_options":
        args = TCLI.build_parser().parse_args(argv)
        TCLI.refuse_unported(args)
        if name == "--steps_per_call":
            assert TCLI.config_from_args(args).steps_per_call == 2
        elif name == "--remat":
            cfg = TCLI.config_from_args(args)
            assert cfg.remat and TC.unsupported_fields(cfg) == []
        else:
            # parsed for maybe_initialize, which main() calls next
            attr = name.lstrip("-")
            want = {"--coordinator": "localhost:1234",
                    "--num_processes": 2, "--process_id": 1,
                    "--distributed": True}[name]
            assert getattr(args, attr) == want
        return
    with pytest.raises(SystemExit, match=name):
        TCLI.main(argv)
    assert not os.path.exists(tmp_path / "ck")
    # accepted and ignored, as in the JAX package
    TCLI.refuse_unported(TCLI.build_parser().parse_args(
        ["train", "--local_rank", "0", "--MASTER_PORT", "1"]))


def test_run_task_export_predict_on_cpu(tmp_path, capsys):
    """`run-task` of VOC 19-1 (two steps) at ResNet-50, crop 32, on 10
    synthetic images, as tests/test_cli_runtask.py drives the JAX CLI;
    then `export` of the step-1 checkpoint at f32 (its tensors bit for
    bit) and bf16, and `predict --save_ids` with the bf16 npz, whose id
    maps equal `predict_labels` of the same model on the same images."""
    ck, logs = str(tmp_path / "ckpt"), str(tmp_path / "logs")
    assert TCLI.main([
        "run-task", "--dataset", "voc", "--task", "19-1", "--step", "0",
        "--method", "LWF", "--backbone", "resnet50", "--crop_size", "32",
        "--batch_size", "4", "--epochs", "1", "--lr", "0.01",
        "--dtype", "float32", "--no_pretrained", "--synthetic", "10",
        "--logdir", logs, "--ckpt_dir", ck, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    steps = [json.loads(line) for line in out.splitlines()
             if line.startswith("{") and "mean_iou" in line]
    assert [s["step"] for s in steps] == [0, 1]
    for s in (0, 1):
        assert os.path.isfile(os.path.join(ck, f"19-1-voc_Experiment_{s}"))
    assert "Final mIoU" in out
    assert os.path.exists(os.path.join(logs, "19-1-voc", "Experiment",
                                       "results.csv"))

    from ucd_torch.engine import checkpoint as TK
    step1 = os.path.join(ck, "19-1-voc_Experiment_1")
    saved = TK.state_dict_of(TK.load_model_state(step1))
    npz = {}
    for dtype in ("float32", "bfloat16"):
        npz[dtype] = str(tmp_path / f"m_{dtype}.npz")
        assert TCLI.main(["export", "--ckpt", step1, "--out", npz[dtype],
                          "--task", "19-1", "--step", "1", "--backbone",
                          "resnet50", "--export_dtype", dtype,
                          "--no_pretrained", "--device", "cpu"]) == 0
    assert "classes=[20, 1]" in capsys.readouterr().out
    model32, meta = load_inference(npz["float32"], device="cpu")
    assert meta["classes"] == [20, 1] and meta["dtype"] == "float32"
    for k, v in model32.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert v.dtype == saved[k].dtype and torch.equal(v, saved[k]), k

    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rs = np.random.RandomState(0)
    arrays = {}
    for i, (h, w) in enumerate([(32, 32), (40, 24), (32, 32), (17, 50)]):
        arrays[f"im{i}"] = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        Image.fromarray(arrays[f"im{i}"]).save(imgs / f"im{i}.png")
    preds = tmp_path / "preds"
    assert TCLI.main(["predict", "--model", npz["bfloat16"], "--images",
                      str(imgs), "--out", str(preds), "--save_ids",
                      "--bucket", "16", "--device", "cpu"]) == 0
    # the API on the same device calls: each bucket's images (in input
    # order, zero-padded to the 16-multiple bucket) as one batch
    model16, _ = load_inference(npz["bfloat16"], device="cpu")
    predictor = Predictor(model16, device="cpu")
    groups = {}
    for stem, img in arrays.items():
        key = (-(-img.shape[0] // 16) * 16, -(-img.shape[1] // 16) * 16)
        groups.setdefault(key, []).append(stem)
    for (hb, wb), stems in groups.items():
        batch = np.zeros((len(stems), hb, wb, 3), np.uint8)
        for i, stem in enumerate(stems):
            h, w = arrays[stem].shape[:2]
            batch[i, :h, :w] = arrays[stem]
        want = predictor.predict_labels(batch).numpy()
        for i, stem in enumerate(stems):
            h, w = arrays[stem].shape[:2]
            assert (preds / f"{stem}_color.png").exists()
            ids = np.asarray(Image.open(preds / f"{stem}_ids.png"))
            np.testing.assert_array_equal(ids, want[i, :h, :w],
                                          err_msg=stem)

    # `test` maps --step_ckpt onto the same-step restore
    assert TCLI.main(["test", "--task", "19-1", "--step", "1", "--method",
                      "LWF", "--backbone", "resnet50", "--crop_size", "32",
                      "--batch_size", "4", "--dtype", "float32",
                      "--no_pretrained", "--synthetic", "10", "--step_ckpt",
                      step1, "--logdir", str(tmp_path / "tlogs"),
                      "--ckpt_dir", str(tmp_path / "tck"), "--visualize",
                      "--device", "cpu"]) == 0
    line = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith('{"step"')]
    assert json.loads(line[-1]) == steps[-1]
    assert not os.path.exists(tmp_path / "tck")  # eval-only: no save


def test_reporting_matches_jax(tmp_path):
    rs = np.random.RandomState(2)
    rows = []
    for step in range(3):
        ious = {i: (float(rs.rand()) if rs.rand() > 0.2 else "X")
                for i in range(21)}
        rows.append((step, ious))
    for name, R in (("t", TR), ("j", JR)):
        for step, ious in rows:
            R.write_step_csv(str(tmp_path / name / "r.csv"), step, ious)
    assert (tmp_path / "t" / "r.csv").read_text() == \
        (tmp_path / "j" / "r.csv").read_text()
    for first in (15, 19):
        at = TR.aggregate_csv(str(tmp_path / "t" / "r.csv"), first)
        aj = JR.aggregate_csv(str(tmp_path / "j" / "r.csv"), first)
        assert at == aj
        assert TR.format_report(at) == JR.format_report(aj)
