"""The port's runbooks, checked without running them: each `*_torch.sh`
is valid bash that calls the port and never the JAX package; every flag
its `python -m ucd_torch.cli` / `ucd_torch` commands pass (comment
examples included) parses with the port's own parser; the port's parity
report prints what the JAX package's prints on one 15-5s results CSV;
and `scripts/check_env_torch.py` fails only on a critical pin."""

import importlib.util
import os
import re
import shlex
import subprocess
import sys

import numpy as np
import pytest

from ucd_torch.cli import build_parser
from ucd_torch.utils.reporting import write_step_csv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNBOOKS = ["examples/voc_15-5s_ucd_torch.sh",
            "examples/ade_100-50_ucd_torch.sh",
            "examples/export_and_serve_torch.sh",
            "scripts/parity_voc_torch.sh",
            "scripts/parity_ade_torch.sh",
            "scripts/install_smoke_torch.sh"]
# stand-ins for the shell variables the commands take
VALUES = {"STEP": "1", "step": "1", "LR": "0.01", "TASK": "15-5s"}


def _read(path):
    with open(os.path.join(ROOT, path)) as f:
        return f.read()


@pytest.mark.parametrize("path", RUNBOOKS)
def test_runbook_is_bash_for_the_port(path):
    rc = subprocess.run(["bash", "-n", os.path.join(ROOT, path)],
                        capture_output=True, text=True)
    assert rc.returncode == 0, rc.stderr
    text = _read(path)
    assert "ucd_torch" in text
    assert "ucd_tpu" not in text


def _lines(text):
    """The script's command lines, continuations joined: live lines, and
    the commands its comments show (a comment's `... --flag` line extends
    a train command)."""
    out = []
    for line in text.splitlines():
        s = line.strip()
        comment = s.startswith("#")
        if comment:
            s = s.lstrip("#").strip()
        if out and out[-1][1] == comment and out[-1][0].endswith("\\"):
            out[-1] = (out[-1][0][:-1] + " " + s, comment)
        else:
            out.append((s, comment))
    return [s for s, _ in out]


def _port_argv(tokens):
    """The arguments after `[python] -m ucd_torch.cli` or a `ucd_torch`
    program in `tokens`, or None."""
    for i, tok in enumerate(tokens):
        if tok == "ucd_torch.cli" and i > 0 and tokens[i - 1] == "-m":
            return tokens[i + 1:]
        if os.path.basename(tok) == "ucd_torch" and i == 0:
            return tokens[1:]
    return None


def _commands(text):
    """Every port command of `text` as argv lists, with the values of each
    `${ARRAY[@]}` the script defines and stand-ins for its variables."""
    arrays = {}
    for name, body in re.findall(r"(\w+)=\(([^)]*)\)", text, re.S):
        arrays.setdefault(name, []).append(shlex.split(body))
    out = []
    for line in _lines(text):
        if line.startswith("..."):
            line = "ucd_torch train " + line[3:]
        try:
            tokens = shlex.split(line)
        except ValueError:
            continue
        argv = _port_argv(tokens)
        if argv is None:
            continue
        if argv[:1] == ["..."]:
            argv = ["train"] + argv[1:]
        argvs = [[]]
        for tok in argv:
            arr = re.fullmatch(r"\$\{(\w+)\[@\]\}", tok)
            if arr:
                argvs = [a + d for a in argvs for d in arrays[arr.group(1)]]
            elif tok != "...":
                var = re.fullmatch(r"\$\{?(\w+)\}?", tok)
                tok = VALUES.get(var.group(1), "x") if var else tok
                argvs = [a + [tok] for a in argvs]
        out += [(a, line) for a in argvs]
    return out


@pytest.mark.parametrize("path", RUNBOOKS)
def test_runbook_flags_parse_with_the_port(path):
    cmds = _commands(_read(path))
    assert cmds, f"{path}: no port command found"
    parser = build_parser()
    for argv, line in cmds:
        try:
            args = parser.parse_args(argv)
        except SystemExit:
            pytest.fail(f"{path}: the port's parser refuses {argv} "
                        f"(from: {line})")
        assert args.command in ("train", "run-task", "export", "predict",
                                "serve", "test"), argv


def _fixture_csv(path):
    """A 15-5s results.csv: six steps, seeded IoUs, classes not yet seen
    absent."""
    rng = np.random.RandomState(13)
    for step in range(6):
        seen = 16 + step
        write_step_csv(path, step, {c: (float(rng.rand()) if c < seen
                                        else "X") for c in range(21)})


def test_parity_report_matches_the_jax_report(tmp_path):
    csv_path = str(tmp_path / "results.csv")
    _fixture_csv(csv_path)
    runs = {}
    for script in ("parity_report.py", "parity_report_torch.py"):
        runs[script] = subprocess.run(
            [sys.executable, os.path.join(ROOT, "scripts", script),
             csv_path, "voc", "15-5s", "--overlap"],
            capture_output=True, text=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
    ref, got = runs["parity_report.py"], runs["parity_report_torch.py"]
    assert "Final mIoU" in ref.stdout, ref.stderr
    assert got.stdout == ref.stdout
    assert got.returncode == ref.returncode


def _check_env():
    spec = importlib.util.spec_from_file_location(
        "check_env_torch", os.path.join(ROOT, "scripts",
                                        "check_env_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ENV_CASES = {
    # name: (installed versions over the lock's, argv, exit code)
    "match": ({}, [], 0),
    "drift_only": ({"numpy": "0.0.1", "pytest": None}, [], 0),
    "torch_mismatch": ({"torch": "2.11.0+cu126"}, [], 1),
    "cuda_mismatch": ({"cuda": "12.6"}, [], 1),
    "nvcc_missing": ({"nvcc": None}, [], 1),
    "cpu_host": ({"torch": "2.11.0+cpu", "cuda": None, "nvcc": None},
                 ["--cpu"], 0),
    "cpu_host_other_release": ({"torch": "2.13.0+cpu", "cuda": None},
                               ["--cpu"], 0),
}


@pytest.mark.parametrize("case", sorted(ENV_CASES))
def test_check_env_exits_1_only_on_a_critical_pin(case, monkeypatch,
                                                   capsys):
    import importlib.metadata as md

    mod = _check_env()
    pins = mod.load_lock(os.path.join(ROOT, "environment",
                                      "requirements_torch.lock"))
    assert {"torch", "cuda", "nvcc"} <= set(pins)
    changes, argv, want = ENV_CASES[case]
    have = {**pins, **changes}

    def version(name):
        if have.get(name) is None:
            raise md.PackageNotFoundError(name)
        return have[name]
    monkeypatch.setattr(md, "version", version)
    monkeypatch.setattr(mod, "torch_cuda", lambda: have["cuda"])
    monkeypatch.setattr(mod, "nvcc_release", lambda: have["nvcc"])
    assert mod.main(argv) == want
    out = capsys.readouterr().out
    assert ("CRITICAL" in out) == (want == 1), out
