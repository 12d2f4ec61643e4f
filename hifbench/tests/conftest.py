"""The benchmark's CPU tests: the repository root on the path, and small
cells (the configurations' generators at a few thousand rows) for driving
the rest of a run on the CPU."""

import dataclasses
import functools
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL_NX = {"poisson2d": 48, "poisson3d": 14}


@functools.cache
def _stated(config_json: str) -> dict:
    """The factorization's shape at the small size, as the configuration
    states the full size's."""
    from hifbench import compare, problems, program

    config = json.loads(config_json)
    A = problems.make(config)
    _, _, levels, tail = program.factorize(config, A, "cpu")
    got = compare.structure(levels, tail, A)
    return {k: got[k] for k in config["stated"]}


@pytest.fixture
def small_cell():
    """``small_cell(name)``: the cell of BENCHMARK.json at a small size,
    with the shape its factorization has there as the stated one."""
    from hifbench import spec

    bench = spec.load_benchmark()

    def make(name):
        cell = spec.resolve(bench, name)
        config = dict(cell.config, nx=SMALL_NX[cell.config["generator"]])
        config["stated"] = _stated(json.dumps(config, sort_keys=True))
        return dataclasses.replace(cell, config=config)

    return make
