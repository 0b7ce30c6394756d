"""The benchmark as data: `BENCHMARK.json` at the checkout's root names the
cells and the metrics; every cell's configuration, traffic mix, limits,
driver and every per-layer metric's reader is a file of its own, found by
its name:

    benchmark/configs/<config>.json     sizes of one configuration
    benchmark/traffic/<traffic>.json    one traffic mix; its "driver" names
    benchmark/drivers/<driver>.py       the generator of that kind of mix
    benchmark/limits/<cell>.json        the limits that decide `correct`
    benchmark/metrics/<metric>.py       the reader of a per-layer metric

So a later change adds a cell, a configuration, a mix or a metric by adding
files and entries, without editing a file that is there.

An end-to-end metric is the value its cell's driver gives under the same
name. One named `<name>.<part>` that the driver does not give is the
driver's `<name>`, held to a bound of its own in the cells it lists: the
same quantity in cells that spread differently (`train_img_per_s.eager`).
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class SpecError(ValueError):
    """The benchmark's data does not hold together."""


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise SpecError(f"{what} {name!r}: a name is 1 to 64 letters, "
                        f"digits, '_', '.' and '-', starting with a letter, "
                        f"a digit or '_'")
    return name


def check_unit(unit: str, what: str) -> str:
    if not isinstance(unit, str) or not UNIT.match(unit):
        raise SpecError(f"{what}: unit {unit!r} is 1 to 16 letters, digits, "
                        f"'_', '/', '%', '.' and '-'")
    return unit


def path_of(kind: str, name: str, base: str = HERE) -> str:
    """The file of `name` among `kind`: configs, traffic, drivers, limits
    or metrics."""
    ext = ".py" if kind in ("drivers", "metrics") else ".json"
    return os.path.join(base, kind, check_name(name, kind[:-1]) + ext)


def read_json(path: str) -> dict:
    if not os.path.isfile(path):
        raise SpecError(f"missing file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    if not os.path.isfile(path):
        raise SpecError(f"missing file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Benchmark:
    """BENCHMARK.json and the files it names, under `base` (the benchmark's
    folder; a test points it at a copy)."""

    def __init__(self, spec: dict, base: str = HERE):
        self.spec, self.base = spec, base
        self.check()

    @classmethod
    def load(cls, root: str = ROOT, base: str = HERE) -> "Benchmark":
        return cls(read_json(os.path.join(root, "BENCHMARK.json")), base)

    def check(self) -> None:
        s = self.spec
        seen = set()
        for c in s["configs"]:
            check_name(c["name"], "config")
            for k in c["reduced"]:
                check_name(k, "reduced key")
        for w in s["workloads"]:
            for k in ("name", "config", "traffic"):
                check_name(w[k], f"workload {k}")
            if w["chips"] not in (1, 4):
                raise SpecError(f"{w['name']}: chips is 1 or 4")
        for m in s["end_to_end"] + s["per_layer"]:
            check_name(m["name"], "metric")
            check_unit(m["unit"], m["name"])
            if m["name"] in seen:
                raise SpecError(f"metric {m['name']} named twice")
            seen.add(m["name"])
            if m["better"] not in ("lower", "higher"):
                raise SpecError(f"{m['name']}: better is lower or higher")
        configs = {c["name"] for c in s["configs"]}
        cells = {w["name"] for w in s["workloads"]}
        for w in s["workloads"]:
            if w["config"] not in configs:
                raise SpecError(f"{w['name']}: unknown config {w['config']}")
        for m in s["per_layer"]:
            if not m.get("workloads"):
                raise SpecError(f"{m['name']}: a per-layer metric lists "
                                f"its workloads")
        for m in s["end_to_end"] + s["per_layer"]:
            for c in m.get("workloads", ()):
                if c not in cells:
                    raise SpecError(f"{m['name']}: unknown workload {c}")

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return read_json(path_of("configs", name, self.base))

    def traffic(self, name: str) -> dict:
        return read_json(path_of("traffic", name, self.base))

    def limits(self, cell: str) -> dict:
        return read_json(path_of("limits", cell, self.base))

    def driver(self, name: str) -> ModuleType:
        return load_module(path_of("drivers", name, self.base),
                           f"benchmark_driver_{name.replace('.', '_')}")

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", (cell,))]

    @staticmethod
    def e2e_value(name: str, values: dict) -> Optional[float]:
        """The value of the end-to-end metric `name` among a driver's
        `values`, as the module's docstring says; None where there is none.
        """
        while name not in values and "." in name:
            name = name.rsplit(".", 1)[0]
        return values.get(name)

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics that list this cell."""
        return [m for m in self.spec["per_layer"] if cell in m["workloads"]]

    def read_per_layer(self, cell: str, records: dict) -> Dict[str, dict]:
        """Each per-layer metric's reader over the traced run's records; a
        reader that finds nothing returns None and its metric is left
        out."""
        out = {}
        for m in self.per_layer(cell):
            mod = load_module(path_of("metrics", m["name"], self.base),
                              "benchmark_metric_"
                              + re.sub(r"\W", "_", m["name"]))
            value: Optional[float] = mod.read(records)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out
