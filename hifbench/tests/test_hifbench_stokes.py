"""The Stokes cell, ``stk256.hifir32``, driven on the CPU at a small grid:
a sound run is correct, traced or not; a HIFIR call broken underneath
(one row of every column altered, one refinement step left out, half the
block's columns left out) and the control (the reference in float32) are
not.  The new readers: ``ir_msolves_per_call`` on fake snapshots of the
program's counters, ``ir_roofline`` on a fake trace, and nothing from
either without a window or a trace."""

import dataclasses
import io
import json
import time

import numpy as np
import pytest

from hifbench import compare, problems, program, program_trace, reference
from hifbench import run as runner
from hifbench import spec

CELL = "stk256.hifir32"
SEED = 2 ** 31 + 21
NX = 64


@pytest.fixture(scope="module")
def cell():
    """The cell at a 64 x 64 grid (4 levels, a dense tail), with the shape
    its factorization has there as the stated one."""
    c = spec.resolve(spec.load_benchmark(), CELL)
    config = dict(c.config, nx=NX)
    A = problems.make(config)
    _, _, levels, tail = program.factorize(config, A, "cpu")
    got = compare.structure(levels, tail, A)
    config["stated"] = {k: got[k] for k in config["stated"]}
    return dataclasses.replace(c, config=config)


def one_run(cell, trace=0):
    args = runner.parse(["--workload", cell.name, "--seed", str(SEED),
                         "--seconds", "0.5", "--trace", str(trace)])
    out = io.StringIO()
    rc = runner.run(args, cell=cell, device="cpu", t0=time.perf_counter(),
                    out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(cell, trace):
    res = one_run(cell, trace)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    if trace:
        assert res["metrics"]["ir_msolves_per_call"]["value"] == 2.0
        assert res["metrics"]["factorize_s"]["value"] > 0
    else:
        assert set(res["metrics"]) == {"rhs_per_s", "apply_p95_ms",
                                       "setup_s"}


def altered(X, nirs):
    X = X.clone()
    X[3] += 1e-2 * X.abs().max()
    return X


def half_left_out(X, nirs):
    X = X.clone()
    X[:, X.shape[1] // 2:] = 0
    return X


@pytest.mark.parametrize("fault", ["altered", "step_left_out",
                                   "half_left_out"])
def test_broken_hifir_is_not_correct(cell, monkeypatch, fault):
    import hifir_tpu_torch as ht

    orig = ht.ir_apply

    def broken(A, prec, b, nirs, r=None):
        if fault == "step_left_out":
            return orig(A, prec, b, nirs - 1, r)
        return {"altered": altered, "half_left_out": half_left_out}[fault](
            orig(A, prec, b, nirs, r), nirs)

    monkeypatch.setattr(ht, "ir_apply", broken)
    res = one_run(cell)
    assert res["correct"] is False
    assert res["checks"]["x_gap"]["value"] > res["checks"]["x_gap"]["limit"]


def test_control_readings(cell):
    """``control.py``'s readings at the small grid: the program's are
    correct, the control's are not and read three times the program's worst
    or more, and each fault planted in the factorization fails one of its
    numbers (the weak factorize fills less)."""
    from hifbench import control

    recs = control.readings(cell, [SEED, 5], [6, SEED + 1], 0.3,
                            device="cpu", out=io.StringIO())
    sound = [r for r in recs if r.get("control") is False]
    ctl = [r for r in recs if r.get("control")]
    faults = [r for r in recs if "fault" in r]
    assert {r["fault"] for r in faults} == {"weak", "p_rolled", "E_dropped"}
    assert all(r["correct"] for r in sound)
    assert not any(r["correct"] for r in ctl)
    for r in faults:
        assert not compare.verdict(r["values"], cell.limits)[0], r
    assert all(r["structure"]["fill"] < cell.config["stated"]["fill"]
               for r in faults if r["fault"] == "weak")
    worst = max(r["values"]["x_gap"] for r in sound)
    assert min(r["values"]["x_gap"] for r in ctl) >= 3 * worst


def test_control_is_not_correct(cell):
    """The reference's HIFIR in float32 in the program's place."""
    drv = spec.load_module(cell.driver)
    A = problems.make(cell.config)
    _, _, levels, tail = program.factorize(cell.config, A, "cpu")
    B = np.random.default_rng(4).standard_normal((A.shape[0], 2))
    rows = problems.stokes2d_mac.null_rows(cell.config)
    B[rows] -= B[rows].mean(axis=0)
    items = drv.control([(B, None)], levels, tail, A, cell.traffic)
    got = drv.judge(items, reference.Prec(levels, tail), A, cell.traffic)
    assert got["x_gap"] > cell.limits["x_gap"]


def test_blocks_are_consistent(cell):
    """Every column of the ring has zero mean over the pressure's rows."""
    drv = spec.load_module(cell.driver)
    A = problems.make(cell.config)
    c = drv.Cell(cell.config, cell.traffic, A, "cpu", SEED, 0.2)
    P = c.B[:, c.null].double()
    assert c.B.shape == (cell.traffic["ring"], A.shape[0],
                         cell.traffic["columns"])
    assert float(P.mean(dim=1).abs().max()) < 1e-12
    assert float(P.std()) > 0.5


def snap(**counters):
    return {"spans": {}, "counters": counters}


@pytest.fixture
def fake(monkeypatch):
    """``fake(*snapshots)``: the program's snapshots, one a call."""
    monkeypatch.setattr(program_trace, "_MARKS", {})

    def feed(*snaps):
        it = iter(snaps)
        monkeypatch.setattr(program_trace, "snapshot", lambda: next(it))

    return feed


def reader(name):
    return spec.load_module(spec.metric_file(name))


@pytest.mark.parametrize("before,after,want", [
    ({"ir.calls": 5, "ir.msolves": 10}, {"ir.calls": 45, "ir.msolves": 90},
     2.0),
    ({}, {"ir.calls": 3, "ir.msolves": 9}, 3.0),
    # a program without the counters, or no call in the window
    ({}, {"trsv_apply_cuda.launches": 12}, None),
    ({"ir.calls": 4, "ir.msolves": 8}, {"ir.calls": 4, "ir.msolves": 8},
     None),
])
def test_ir_msolves_per_call(fake, before, after, want):
    m = reader("ir_msolves_per_call")
    fake(snap(**before), snap(**after))
    assert m.counters() == {} and m.counters() == {}
    assert m.read({}) == want


def test_ir_msolves_per_call_without_a_window(fake):
    m = reader("ir_msolves_per_call")
    assert m.read({}) is None
    fake(None, None)
    m.counters()
    m.counters()
    assert m.read({}) is None


@dataclasses.dataclass
class FakeTrace:
    busy_s: float


def test_ir_roofline(cell):
    from hifbench.peaks import least_seconds
    from hifbench.work.ir import ir_work
    from hifbench.work.msolve import msolve_work

    A = problems.make(cell.config)
    _, _, levels, tail = program.factorize(cell.config, A, "cpu")
    ctx = dict(levels=levels, tail_n=tail.shape[0], n=A.shape[0],
               nnz_a=int(A.nnz), nrhs=32, nirs=2, es=8, dtype="float64",
               solves=10)
    m = reader("ir_roofline")
    assert m.read(ctx) is None
    assert m.read(dict(ctx, trace=FakeTrace(0.0))) is None
    nb, fl = ir_work(levels, ctx["tail_n"], ctx["n"], ctx["nnz_a"], 32, 2, 8)
    mb, mf = msolve_work(levels, ctx["tail_n"], ctx["n"], 32, 8)
    # two M-solves and one residual: A's entries, row pointers, X, B, R
    assert nb == 2 * mb + int(A.nnz) * 12 + 4 * (A.shape[0] + 1) \
        + 3 * A.shape[0] * 32 * 8
    assert fl == 2 * mf + 2 * int(A.nnz) * 32
    got = m.read(dict(ctx, trace=FakeTrace(2.0)))
    assert got == pytest.approx(100.0 * 10 * least_seconds(nb, fl,
                                                           "float64") / 2.0)
    # an apply cell's context has no nirs: nothing
    assert m.read({k: v for k, v in dict(ctx, trace=FakeTrace(2.0)).items()
                   if k != "nirs"}) is None


@pytest.mark.parametrize("name", ["k2_roofline.hifir", "k2_tile_pct.hifir",
                                  "device_idle_pct.hifir",
                                  "program_idle_pct.hifir"])
def test_new_entries_load_the_old_readers(name):
    assert spec.metric_file(name) == spec.metric_file(name.split(".")[0])


def test_reference_ir_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); import hifbench.reference_ir,"
            " hifbench.work.ir, hifbench.problems.stokes2d_mac; print(sorted("
            "{m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', "
            "'flax', 'hifir_tpu', 'hifir_tpu_torch', 'torch'}))"
            % str(spec.ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
