"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) resolves to ``configs/<config>.json``,
``traffic/<traffic>.json``, ``drivers/<kind>.py`` (the traffic's
``kind``), ``cells/<cell>.json`` (its limits) and, for each per-layer
metric it reports, ``metrics/<metric>.py`` or, where no file has the whole
name, ``metrics/<the name before its first dot>.py``."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

__all__ = ["HERE", "ROOT", "Cell", "load_benchmark", "resolve", "load_module",
           "metric_file"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path):
    """A module from its file (metric and driver names need not be Python
    identifiers)."""
    spec = importlib.util.spec_from_file_location(
        "hifbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_file(name: str) -> Path:
    whole = HERE / "metrics" / f"{name}.py"
    return whole if whole.exists() else \
        HERE / "metrics" / f"{name.split('.')[0]}.py"


@dataclasses.dataclass
class Cell:
    """One cell with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    driver: Path
    end_to_end: list     # the entries of BENCHMARK.json it reports
    per_layer: list


def resolve(bench: dict, name: str) -> Cell:
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "cells" / f"{name}.json").read_text())
    return Cell(name, int(w["chips"]), config, traffic, limits["limits"],
                HERE / "drivers" / f"{traffic['kind']}.py",
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])
