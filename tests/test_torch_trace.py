"""The port's spans and counters (``hifir_tpu_torch/trace.py``), on the CPU.

Spans nest and add to per-name totals; a ``record_function`` range is
opened only while a profiler records, and then the ranges are host events
of its trace.  The program's spans and counters are held to what happened:
the factorize's and the pack's phases, the GMRES driver's reads and steps
(against its segments, counted by a wrapper), and the graph cache's first
call, copies and launch counters, over a stand-in backend that captures and
replays on the CPU.  Totals are process-wide, so every check reads the gain
between two snapshots.
"""

import math

import numpy as np
import pytest
import torch

import hifir_tpu_torch as ht
from hifir_tpu_torch import graphs, trace
from hifir_tpu_torch.alg.prec import DevicePrec
from hifir_tpu_torch.models.problems import poisson2d
from hifir_tpu_torch.ops import spmv, trsv
from hifir_tpu_torch.ops.spmv import sliced_ell_from_csr
from hifir_tpu_torch.options import VERBOSE_PRE_TIME
from hifir_tpu_torch.solvers import gmres

CPU = "cpu"
OPTS = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5, kappa_d=5,
            verbose=0, dense_thres=30)


def _gain(before, after):
    """Span counts and counter values gained between two snapshots."""
    spans = {k: n - before["spans"].get(k, (0.0, 0))[1]
             for k, (_, n) in after["spans"].items()}
    counts = {k: v - before["counters"].get(k, 0)
              for k, v in after["counters"].items()}
    return ({k: n for k, n in spans.items() if n},
            {k: v for k, v in counts.items() if v})


@pytest.fixture(scope="module")
def p16():
    A = poisson2d(16)
    M = ht.HIF().factorize(A, ht.Options(**OPTS), device=CPU)
    return A, M


def test_span_nesting_and_totals():
    s0 = trace.snapshot()
    with trace.span("hifir.test.outer") as outer:
        for _ in range(3):
            with trace.span("hifir.test.inner") as inner:
                sum(range(1000))
    trace.add("test.count")
    trace.add("test.count", 4)
    s1 = trace.snapshot()
    spans, counts = _gain(s0, s1)
    assert spans == {"hifir.test.outer": 1, "hifir.test.inner": 3}
    assert counts == {"test.count": 5}
    sec = {k: s1["spans"][k][0] - s0["spans"].get(k, (0.0, 0))[0]
           for k in spans}
    assert 0 < inner.seconds <= sec["hifir.test.inner"] \
        <= sec["hifir.test.outer"] == pytest.approx(outer.seconds)
    # the launch counters are read under their wrappers' names
    assert s1["counters"]["trsv_apply_cuda.launches"] == \
        trsv.trsv_apply_cuda.launches
    assert len(trace.launch_counters()) == len(graphs.read_counters()) == 19


def test_k2_tile_launches_are_a_launch_counter(monkeypatch):
    """K2's tile-form launches, then its levels walked, its launches with
    x in shared memory and its launches of one column on a cluster, are
    read with the launch counters, last, so that a replay re-adds what its
    capture counted and the earlier counters keep their places."""
    names = [name for _, _, name in trace.launch_counters()]
    assert names[-4:] == ["trsv_apply_cuda.tile_launches",
                          "trsv_apply_cuda.levels",
                          "trsv_apply_cuda.smem_launches",
                          "trsv_apply_cuda.split_launches"]
    assert names.index("trsv_apply_cuda.launches") == 2
    monkeypatch.setattr(trsv.trsv_apply_cuda, "tile_launches", 7)
    monkeypatch.setattr(trsv.trsv_apply_cuda, "levels", 9)
    monkeypatch.setattr(trsv.trsv_apply_cuda, "smem_launches", 5)
    monkeypatch.setattr(trsv.trsv_apply_cuda, "split_launches", 3)
    counters = trace.snapshot()["counters"]
    assert counters["trsv_apply_cuda.tile_launches"] == 7
    assert counters["trsv_apply_cuda.levels"] == 9
    assert counters["trsv_apply_cuda.smem_launches"] == 5
    assert counters["trsv_apply_cuda.split_launches"] == 3
    assert graphs.read_counters()[-4:] == (7, 9, 5, 3)


def test_no_range_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace.span("hifir.test.quiet") as s:
        pass
    assert s.seconds >= 0
    with pytest.raises(AssertionError):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]):
            with trace.span("hifir.test.loud"):
                pass


def test_ranges_are_host_events_of_a_profile(p16):
    A, M = p16
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        dp = M.to_device(dtype=np.float64, device=CPU)
        dp.solve_mrhs(np.ones((A.nrows, 2)))
        with trace.span("hifir.test.outer"):
            with trace.span("hifir.test.inner"):
                pass
    events = {e.name(): (e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()}
    assert {"hifir.pack", "hifir.pack.trsv", "hifir.pack.ell",
            "hifir.pack.tail", "hifir.solve"} <= set(events)
    (o0, o1), (i0, i1) = events["hifir.test.outer"], events["hifir.test.inner"]
    assert o0 <= i0 <= i1 <= o1


def test_factorize_and_to_device_emit_their_spans(p16, capsys):
    A, _ = p16
    s0 = trace.snapshot()
    M = ht.HIF().factorize(A, ht.Options(**dict(OPTS,
                                                verbose=VERBOSE_PRE_TIME)),
                           device=CPU)
    s1 = trace.snapshot()
    dp = M.to_device(dtype=np.float64, device=CPU)
    s2 = trace.snapshot()
    dp.pack_prod(M.precs)
    b = np.ones(A.nrows)
    dp.solve(b)
    dp.mmultiply(b)
    s3 = trace.snapshot()
    levels = len(M.precs)
    assert M.precs[-1].dense_solver is not None
    spans, _ = _gain(s0, s1)
    assert spans["hifir.factorize"] == 1
    assert spans["hifir.factorize.level"] == levels
    assert spans["hifir.factorize.pre"] == spans["hifir.factorize.crout"] \
        == levels
    assert spans["hifir.factorize.tail"] == 1
    # the report under VERBOSE_PRE_TIME: each phase, then the total
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in out] == ["preprocessing", "crout",
                                             "schur", "dense", "factorize"]
    total = s1["spans"]["hifir.factorize"][0] - \
        s0["spans"].get("hifir.factorize", (0.0, 0))[0]
    assert float(out[-1].split()[-1][:-1]) == pytest.approx(total, rel=1e-5)
    spans, _ = _gain(s1, s2)
    assert spans == {"hifir.pack": 1, "hifir.pack.trsv": levels,
                     "hifir.pack.ell": levels, "hifir.pack.tail": 1}
    spans, _ = _gain(s2, s3)
    assert spans == {"hifir.solve": 2}


@pytest.mark.parametrize("restart", [30, 3])
def test_gmres_counts_reads_and_steps(p16, monkeypatch, restart):
    """``gmres.reads`` is ||b|| plus one a segment; the steps the segments
    run and those the cycles use, which add up to the iterations: in one
    cycle (restart 30) and in cycles of one segment shorter than
    ``SEGMENT`` (restart 3)."""
    A, M = p16
    dp = M.to_device(dtype=np.float64, device=CPU)
    As = sliced_ell_from_csr(A, device=CPU)
    segments = []
    orig = gmres._segment

    def counted(A, levels, tail, nirs, r, j0, j1, w):
        segments.append(j1 - j0)
        return orig(A, levels, tail, nirs, r, j0, j1, w)

    monkeypatch.setattr(gmres, "_segment", counted)
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(A.nrows))
    s0 = trace.snapshot()
    x, flag, it = ht.gmres_hif(As, dp, b, restart=restart, rtol=1e-10)
    spans, counts = _gain(s0, trace.snapshot())
    assert flag == 0 and (it < restart) == (restart == 30)
    assert counts["gmres.reads"] == 1 + len(segments)
    assert counts["gmres.steps_run"] == sum(segments)
    assert counts["gmres.steps_used"] == it
    assert spans["hifir.gmres"] == 1
    assert spans["hifir.gmres.read"] == counts["gmres.reads"]
    assert len(segments) == (math.ceil(it / gmres.SEGMENT) if restart == 30
                             else math.ceil(it / restart))


class StubGraphs:
    """A capture backend on the CPU: the capture runs the program (so the
    launch counters move as they do while a graph is captured) and keeps
    its arguments; a replay runs it again into the static output with the
    counters held, since a replay runs no Python."""

    def __init__(self, device):
        self.device = device

    def warm(self, fn, args):
        return fn(*args)

    def capture(self, fn, args):
        out = fn(*args)
        return (fn, args, out), out

    def replay(self, graph):
        fn, args, out = graph
        held = graphs.read_counters()
        out.copy_(fn(*args))
        graphs._set_counters(held)


def test_graph_cache_copies_first_call_and_launches(p16, monkeypatch):
    A, M = p16
    monkeypatch.setitem(graphs.BACKENDS, "cpu", StubGraphs)
    dp = M.to_device(dtype=np.float64, device=CPU, dense_inv=0)
    ref = DevicePrec.from_host(M.precs, dtype=np.float64, device=CPU,
                               dense_inv=0, graphs=False)
    B = torch.ones((A.nrows, 3), dtype=torch.float64)
    s0 = trace.snapshot()
    ref.solve_mrhs(B)
    _, once = _gain(s0, trace.snapshot())
    assert once["trsv_apply_plain.calls"] > 0 \
        and once["sliced_ell_sub_mrhs_plain.calls"] > 0
    copy = 2 * B.nbytes                 # B in, X out
    s1 = trace.snapshot()
    X = dp.solve_mrhs(B)                # the first call: warm-up, capture
    s2 = trace.snapshot()
    spans, counts = _gain(s1, s2)
    assert {k: spans[k] for k in ("hifir.graph.call", "hifir.graph.key",
                                  "hifir.graph.first", "hifir.graph.warm",
                                  "hifir.graph.capture", "hifir.graph.out")} \
        == dict.fromkeys(("hifir.graph.call", "hifir.graph.key",
                          "hifir.graph.first", "hifir.graph.warm",
                          "hifir.graph.capture", "hifir.graph.out"), 1)
    assert "hifir.graph.replay" not in spans
    assert counts.pop("graph.copy_bytes") == copy
    assert counts == once               # the warm-up's launches count
    (ent,) = dp.graph_cache.entries.values()
    first = s2["spans"]["hifir.graph.first"][0] - \
        s1["spans"].get("hifir.graph.first", (0.0, 0))[0]
    assert ent.seconds == pytest.approx(first)
    assert {(o.__name__, a) for o, a, _ in ent.moved} == {
        tuple(k.split(".")) for k in once}
    for n in (1, 4):
        s3 = trace.snapshot()
        for _ in range(n):
            Xr = dp.solve_mrhs(B)
        spans, counts = _gain(s3, trace.snapshot())
        assert spans["hifir.graph.replay"] == spans["hifir.graph.copy_in"] \
            == n and "hifir.graph.first" not in spans
        assert counts.pop("graph.copy_bytes") == n * copy
        assert counts == {k: n * v for k, v in once.items()}
    torch.testing.assert_close(Xr, X, rtol=0, atol=0)
    assert spmv.sell_spmv_cuda.launches == s0["counters"][
        "sell_spmv_cuda.launches"]
