"""Enclosed-flow 2-D Stokes on a MAC grid (``models/problems.py:
stokes2d_mac``) and HIFIR (``solvers/ir.py:ir_apply``) on it, on the CPU.

The operator is exactly symmetric, singular with the constant pressure as
its null vector, has the closed-form count of entries, and is the matrix
the benchmark's frozen copy builds.  ``ir_apply`` is held to the plain
reference of the benchmark (``hifbench/reference_ir.py``, numpy and scipy
on the host factorization) in every triangular form a pack can take, and
its span and counters to the calls made, replays included.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import hifir_tpu_torch as ht
from hifir_tpu_torch import graphs, trace
from hifir_tpu_torch.alg.prec import DevicePrec
from hifir_tpu_torch.models.problems import stokes2d_mac
from hifir_tpu_torch.ops.spmv import sliced_ell_from_csr
from hifir_tpu_torch.ops.trsv import TrsvBlockDense, TrsvDense, TrsvSchedule

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from hifbench import reference, reference_ir  # noqa: E402
from hifbench.hostprec import host_levels  # noqa: E402
from hifbench.problems import stokes2d_mac as bench_stokes  # noqa: E402

CPU = "cpu"
# the pack's triangular forms by dense_inv at N = 16 and 32 (levels of
# 255-1541 rows): every level scanned; blocked inverses up to 8 x 64 rows;
# explicit dense inverses up to 2048
FORMS = {0: TrsvSchedule, 64: TrsvBlockDense, "auto": TrsvDense}


def n_entries(N: int) -> int:
    """Two Laplacians (diagonal, neighbours along x and y) and D, D^T."""
    lap = (N - 1) * N + 2 * (N - 2) * N + 2 * (N - 1) ** 2
    return 2 * lap + 8 * (N - 1) * N


@pytest.mark.parametrize("N", [8, 16, 32])
def test_stokes_symmetric_singular_and_sized(N):
    A = stokes2d_mac(N).to_scipy()
    n = 2 * N * (N - 1) + N * N
    assert A.shape == (n, n) and A.nnz == n_entries(N)
    assert (A != A.T).nnz == 0
    ones_p = np.zeros(n)
    ones_p[2 * N * (N - 1):] = 1.0
    assert np.linalg.norm(A @ ones_p) <= 1e-12
    h2 = N * N
    d = A.diagonal()
    # 4/h^2 inside, 5/h^2 beside a wall parallel to the velocity, the
    # pressure's diagonal structurally zero
    assert set(np.unique(d[:2 * N * (N - 1)])) == {4.0 * h2, 5.0 * h2}
    assert not d[2 * N * (N - 1):].any()


@pytest.mark.parametrize("N", [8, 16, 32])
def test_stokes_is_the_benchmark_copy(N):
    A = stokes2d_mac(N).to_scipy()
    B = bench_stokes.stokes2d_mac(N)
    assert np.array_equal(A.indptr, B.indptr)
    assert np.array_equal(A.indices, B.indices)
    assert np.array_equal(A.data, B.data)
    rows = bench_stokes.null_rows({"nx": N})
    assert rows.stop == A.shape[0] and rows.stop - rows.start == N * N


@pytest.fixture(scope="module")
def stokes():
    """``stokes(N)``: A, its host factorization under the robust defaults
    and the reference's float64 preparation, made once an N."""
    made = {}

    def get(N):
        if N not in made:
            A = stokes2d_mac(N)
            M = ht.HIF().factorize(A, ht.Options(verbose=0), device=CPU)
            made[N] = (A, M, reference.Prec(*host_levels(M.precs)))
        return made[N]

    return get


def consistent(N: int, k: int, seed: int) -> np.ndarray:
    """k seeded normal columns, each with its pressure mean removed."""
    n = 2 * N * (N - 1) + N * N
    B = np.random.default_rng(seed).standard_normal((n, k))
    B[2 * N * (N - 1):] -= B[2 * N * (N - 1):].mean(axis=0)
    return B


@pytest.mark.parametrize("nirs", [1, 2, 3])
@pytest.mark.parametrize("dense_inv", [0, 64, "auto"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("N", [16, 32])
def test_ir_apply_matches_reference(stokes, N, dtype, dense_inv, nirs):
    A, M, P = stokes(N)
    dp = M.to_device(dtype=np.dtype(dtype), device=CPU, dense_inv=dense_inv)
    assert FORMS[dense_inv] in {type(f) for lv in dp.levels
                                for f in (lv.L, lv.U)}
    As = sliced_ell_from_csr(A, dtype=np.dtype(dtype), device=CPU)
    B = consistent(N, 3, seed=N + nirs)
    X = ht.ir_apply(As, dp, torch.as_tensor(B.astype(dtype)), nirs=nirs)
    want = reference_ir.hifir(P, A.to_scipy(), B, nirs)
    gap = np.abs(X.double().numpy() - want).max() / np.abs(want).max()
    # float64: the program and the reference round differently in each
    # triangular solve; 3e-15 to 1e-13 read at these sizes, and the
    # refinement's amplification stays far under 1e-10.  float32: the
    # pack's rounding, 1e-7 to 1e-6 read, held well under 1e-4
    assert gap <= (1e-10 if dtype == np.float64 else 1e-4)


def _gain(before, after):
    spans = {k: n - before["spans"].get(k, (0.0, 0))[1]
             for k, (_, n) in after["spans"].items()}
    counts = {k: v - before["counters"].get(k, 0)
              for k, v in after["counters"].items()}
    return ({k: n for k, n in spans.items() if n},
            {k: v for k, v in counts.items() if v})


class StubGraphs:
    """A capture backend on the CPU: the capture runs the program and keeps
    its arguments; a replay runs it again into the static output with the
    launch counters held, since a replay runs no Python."""

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


@pytest.mark.parametrize("captured", [False, True])
@pytest.mark.parametrize("nirs", [1, 3])
def test_ir_apply_span_and_counters(stokes, monkeypatch, captured, nirs):
    """Each call adds one ``hifir.ir`` span, 1 to ``ir.calls`` and ``nirs``
    to ``ir.msolves``, eager or captured and replayed; the graph call runs
    inside the span; neither counter is a launch counter."""
    A, M, _ = stokes(16)
    monkeypatch.setitem(graphs.BACKENDS, "cpu", StubGraphs)
    dp = DevicePrec.from_host(M.precs, dtype=np.float64, device=CPU,
                              dense_inv=0, graphs=captured)
    As = sliced_ell_from_csr(A, device=CPU)
    B = torch.as_tensor(consistent(16, 2, seed=5))
    calls = 4
    s0 = trace.snapshot()
    for _ in range(calls):
        X = ht.ir_apply(As, dp, B, nirs=nirs)
    spans, counts = _gain(s0, trace.snapshot())
    assert spans["hifir.ir"] == calls
    assert counts["ir.calls"] == calls
    assert counts["ir.msolves"] == calls * nirs
    assert spans.get("hifir.graph.call", 0) == (calls if captured else 0)
    assert spans.get("hifir.graph.replay", 0) == \
        (calls - 1 if captured else 0)
    names = {name for _, _, name in trace.launch_counters()}
    assert not {"ir.calls", "ir.msolves"} & names
    eager = ht.ir_apply(As, DevicePrec.from_host(
        M.precs, dtype=np.float64, device=CPU, dense_inv=0, graphs=False),
        B, nirs=nirs)
    torch.testing.assert_close(X, eager, rtol=0, atol=0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ht.ir_apply(As, dp, B, nirs=nirs)
    events = {e.name(): (e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()}
    (o0, o1) = events["hifir.ir"]
    if captured:
        (i0, i1) = events["hifir.graph.call"]
        assert o0 <= i0 <= i1 <= o1
