"""The metrics that read the program's own spans and counters
(``hifbench/program_trace.py`` and its metric files): on fake snapshots and
a fake context, on fake trace records, on a program without
``hifir_tpu_torch.trace``, and in whole traced runs on the CPU with a
stand-in capture backend, so that the graph cache's spans and counters run
too."""

import copy
import io
import json
import sys
import time

import pytest

from hifbench import program_trace, spec
from hifbench import run as runner
from hifbench.trace import WINDOW_SPAN, reduce_trace

MS = 1_000_000
COUNTERS = ["graph_copy_mb", "program_reads_per_system", "arnoldi_use_pct"]


def metric(name):
    return spec.load_module(spec.metric_file(name))


def snap(spans=None, **counters):
    return {"spans": spans or {}, "counters": counters}


@pytest.fixture
def fake(monkeypatch):
    """``fake(*snapshots)``: the program's snapshots, one a call."""
    monkeypatch.setattr(program_trace, "_MARKS", {})

    def feed(*snaps):
        it = iter(snaps)
        monkeypatch.setattr(program_trace, "snapshot", lambda: next(it))

    return feed


@pytest.mark.parametrize("name,before,after,ctx,want", [
    # 1M rows, 64 f32 columns, in and out, over 3 calls
    ("graph_copy_mb", {"graph.copy_bytes": 7},
     {"graph.copy_bytes": 7 + 3 * 2 * 1048576 * 64 * 4}, {"solves": 3},
     536.870912),
    ("program_reads_per_system", {"gmres.reads": 5}, {"gmres.reads": 19},
     {"solves": 2}, 7.0),
    ("arnoldi_use_pct", {"gmres.steps_run": 10, "gmres.steps_used": 9},
     {"gmres.steps_run": 110, "gmres.steps_used": 107}, {"solves": 2},
     98.0),
])
def test_counter_metrics_read_the_last_take(fake, name, before, after, ctx,
                                            want):
    """The hook marks before and after each take and holds the trace to
    nothing; ``read`` takes the last two marks, loaded afresh as the
    harness loads it."""
    first = snap(**{k: 0 for k in before})
    fake(first, first, snap(**before), snap(**after))
    hook = metric(name)
    for _ in range(4):          # two takes
        assert hook.counters() == {}
    assert metric(name).read(ctx) == pytest.approx(want)


@pytest.mark.parametrize("name", COUNTERS)
def test_counter_metrics_read_nothing_without_the_window(fake, name):
    fake(snap(), snap())
    mod = metric(name)
    assert mod.read({"solves": 3}) is None        # never marked
    mod.counters()
    mod.counters()
    assert mod.read({"solves": 3}) is None        # no such counter


@pytest.mark.parametrize("name,span", [("pack_s", "hifir.pack"),
                                       ("capture_s", "hifir.graph.first")])
def test_span_metrics_read_the_run_total(fake, name, span):
    fake(snap({span: (1.25, 3)}), snap({}))
    assert metric(name).read({}) == 1.25
    assert metric(name).read({}) is None          # no such span yet


def records():
    """A 100 ms window: the device busy in [10, 40] and [60, 90]; the gaps'
    middles fall in the benchmark's call with no host op (5 ms), in the
    program's input copy (50 ms) and in an op inside it (95 ms)."""
    return [(WINDOW_SPAN, False, 0, 100 * MS),
            ("hifbench.apply.call", False, 0, 100 * MS),
            ("hifir.graph.call", False, 45 * MS, 100 * MS),
            ("hifir.graph.copy_in", False, 46 * MS, 58 * MS),
            ("hifir.graph.out", False, 92 * MS, 99 * MS),
            ("aten::clone", False, 93 * MS, 98 * MS),
            ("void trsv_solve_kernel<float, 8>(...)", True, 10 * MS, 40 * MS),
            ("Memcpy DtoD (Device -> Device)", True, 60 * MS, 90 * MS)]


def test_program_idle_reads_the_hifir_gaps(fake):
    t = reduce_trace(records())
    assert t.idle_by_host == {
        "hifbench.apply.call/none": pytest.approx(0.010),
        "hifbench.apply.call/hifir.graph.copy_in": pytest.approx(0.020),
        "hifbench.apply.call/aten::clone": pytest.approx(0.010)}
    fake(snap())
    assert metric("program_idle_pct.apply").read({"trace": t}) == \
        pytest.approx(20.0)


@pytest.mark.parametrize("name", ["pack_s", "capture_s",
                                  "program_idle_pct.gmres"] + COUNTERS)
def test_a_program_without_the_trace_module_reads_nothing(monkeypatch,
                                                         name):
    """A tree from before ``hifir_tpu_torch.trace``: nothing raises."""
    import hifir_tpu_torch

    monkeypatch.setattr(program_trace, "_MARKS", {})
    monkeypatch.delattr(hifir_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "hifir_tpu_torch.trace", None)
    assert program_trace.snapshot() is None
    mod = metric(name)
    if hasattr(mod, "counters"):
        assert mod.counters() == {} and mod.counters() == {}
    ctx = {"trace": reduce_trace(records()), "solves": 3}
    assert mod.read(ctx) is None


class StandIn:
    """A capture backend on the CPU: the capture runs the program on copies
    of its arguments (the launch counters move as under a capture), a
    replay runs it on the static arguments with the counters held."""

    def __init__(self, device):
        self.device = device

    def warm(self, fn, args):
        return fn(*args)

    def capture(self, fn, args):
        out = fn(*copy.deepcopy(args))
        return (fn, args, out), out

    def replay(self, graph):
        from hifir_tpu_torch import graphs

        fn, args, out = graph
        held = graphs.read_counters()
        new = fn(*args)
        graphs._set_counters(held)
        if out is not None:
            out.copy_(new)


@pytest.mark.parametrize("name", ["p2d1m.apply64", "p3d64.gmres1"])
def test_traced_runs_report_every_new_metric(small_cell, monkeypatch, name):
    from hifir_tpu_torch import graphs

    monkeypatch.setitem(graphs.BACKENDS, "cpu", StandIn)
    cell = small_cell(name)
    args = runner.parse(["--workload", name, "--seed", str(2 ** 31 + 5),
                         "--seconds", "0.5", "--trace", "1"])
    out = io.StringIO()
    assert runner.run(args, cell=cell, device="cpu", t0=time.perf_counter(),
                      out=out) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got["pack_s"] > 0 and got["capture_s"] > 0
    if name.endswith("apply64"):
        n, cols = cell.config["nx"] ** 2, 64
        assert got["graph_copy_mb"] == pytest.approx(2 * n * cols * 4 / 1e6)
        assert got["program_idle_pct.apply"] >= 0
    else:
        assert got["program_reads_per_system"] >= 2
        assert 0 < got["arnoldi_use_pct"] <= 100
        assert got["program_idle_pct.gmres"] >= 0
