#!/usr/bin/env python3
"""The readings that a cell's limits are set from, at the cell's own size,
in one process (one factorize for the program, one for the weak plant):

    python3 hifbench/control.py --workload <cell> --seeds 11 12 ... \
        --control-seeds 21 22 23 [--seconds 3]

For each of ``--seeds``: the program's short window at the cell's load,
then the run's comparisons (the lower readings).  For each of
``--control-seeds``: the same, with the control in the program's place: the
plain reference computed in the precision below the configuration's
(``drivers/<kind>.py:control``), which has to come out not correct (the
upper readings).  Then the factorize's own numbers
(:func:`hifbench.compare.factorization`) for faults planted in the host
factorization, on each control seed: the same options with the dropping
thresholds ten times larger (``weak``, a factorize of its own), the first
level's row permutation off by one position, its E block left out.  One
JSON line a seed; the benchmark's runs never run this.  It needs the
card, as a run does."""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _roll_p(levels, tail):
    lv = dict(levels[0], p=np.roll(levels[0]["p"], 1))
    return [lv] + levels[1:], tail


def _drop_e(levels, tail):
    E = levels[0]["E"].copy()
    E.data[:] = 0
    return [dict(levels[0], E=E)] + levels[1:], tail


# faults planted in the host factorization, besides ``weak``
FACTOR_FAULTS = {"p_rolled": _roll_p, "E_dropped": _drop_e}
def weak_options(options: dict) -> dict:
    """The configuration's options with the dropping thresholds ten times
    larger (than the upstream default 1e-4 where the options leave them)."""
    return dict(options, **{k: 10 * options.get(k, 1e-4)
                            for k in ("tau_L", "tau_U")})


def readings(cell, seeds, control_seeds, seconds, device="cuda", out=None):
    """Yield one record a seed (``control`` false for the program's
    readings, true for the control's) and one a planted fault and
    control seed."""
    from hifbench import compare, problems, program, reference, spec
    from hifbench.trace import Spans
    from hifbench.window import closed_loop

    out = out or sys.stdout
    drv = spec.load_module(cell.driver)
    A = problems.make(cell.config)
    first = (list(seeds) + list(control_seeds))[0]
    c = drv.Cell(cell.config, cell.traffic, A, device, first, seconds)
    spans = Spans(False)
    P = reference.Prec(c.levels, c.tail)
    stated = cell.config["stated"]
    recs = []

    def emit(rec):
        print(json.dumps(rec), file=out, flush=True)
        recs.append(rec)

    for seed, is_control in ([(s, False) for s in seeds]
                             + [(s, True) for s in control_seeds]):
        c.reset(seed, seconds)
        win = closed_loop(lambda i: c.request(i, spans), seconds)
        _, failed = c.counts(win)
        items = c.sample(win)
        t0 = time.perf_counter()
        if is_control:
            items = drv.control(items, c.levels, c.tail, A, cell.traffic)
        values = drv.judge(items, P, A, cell.traffic)
        values.update(compare.factorization(c.levels, c.tail, A, stated,
                                            seed, P=P))
        values["failed"] = 0 if is_control else failed
        correct, checks = compare.verdict(values, cell.limits)
        emit(dict(workload=cell.name, seed=seed, control=is_control,
                  correct=correct, requests=win.count,
                  reference_s=time.perf_counter() - t0, values=values,
                  limits=cell.limits,
                  structure=compare.structure(c.levels, c.tail, A)))
    c.free()
    weak = program.factorize(dict(cell.config, options=weak_options(
        cell.config["options"])), A, device)[2:]
    plants = dict(weak=lambda lv, t: weak,
                  **FACTOR_FAULTS)
    for name, plant in plants.items():
        levels, tail = plant(c.levels, c.tail)
        for seed in control_seeds or [first]:
            emit(dict(workload=cell.name, seed=seed, fault=name,
                      structure=compare.structure(levels, tail, A),
                      values=compare.factorization(levels, tail, A, stated,
                                                   seed)))
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    from hifbench import spec
    from hifbench.run import card_missing

    cell = spec.resolve(spec.load_benchmark(), args.workload)
    missing = card_missing(torch, cell.chips)
    if missing:
        print(missing, file=sys.stderr)
        return 2
    readings(cell, args.seeds, args.control_seeds, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
