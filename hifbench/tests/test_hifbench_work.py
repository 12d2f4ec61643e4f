"""The operation and byte counts against hand counts on a small
factorization, and the per-layer readers on fake contexts."""

import numpy as np
import pytest
import scipy.sparse as sp

from hifbench import peaks, spec
from hifbench.trace import DeviceTrace
from hifbench.work.gmres import gmres_work
from hifbench.work.k2 import SCAN_ABOVE, k2_launches, k2_work
from hifbench.work.msolve import msolve_work


def level(m, n, nnz):
    """A level dict with L, U, E, F of the given entry counts."""
    shapes = {"L": (m, m), "U": (m, m), "E": (n - m, m), "F": (m, n - m)}
    out = dict(m=m, n=n)
    for k, (r, c) in shapes.items():
        A = sp.lil_matrix((r, c))
        for i in range(nnz[k]):
            A[i % r, i // r] = 1.0
        out[k] = A.tocsr()
    return out


LEVELS = [level(6, 10, dict(L=5, U=7, E=3, F=2)),
          level(3, 4, dict(L=2, U=1, E=1, F=1))]


def test_msolve_by_hand():
    nb, fl = msolve_work(LEVELS, 1, 10, 2, 8)
    entries = (5 + 7 + 3 + 2) + (2 + 1 + 1 + 1)
    ptrs = (2 * 7 + 5 + 7) + (2 * 4 + 2 + 4)
    assert nb == entries * 12 + 4 * ptrs + 1 * 1 * 8 + 2 * 10 * 2 * 8
    assert fl == 2 * 2 * ((10 + 14 + 3 + 2) + (4 + 2 + 1 + 1)) + 4 * 1 * 2


def test_msolve_on_a_factorization():
    """Every entry of a real host factorization counts once."""
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.ds.csr import CSR

    from hifbench import problems
    from hifbench.hostprec import host_levels

    A = problems.make({"generator": "poisson2d", "nx": 40})
    P = ht.HIF().factorize(CSR.from_scipy(A), ht.Options(verbose=0),
                           device="cpu")
    levels, tail = host_levels(P.precs)
    nt = tail.shape[0]
    nb, _ = msolve_work(levels, nt, A.shape[0], 1, 4)
    ent = sum(p.L_B.nnz + p.U_B.nnz + p.E.nnz + p.F.nnz for p in P.precs)
    ptr = sum(3 * (p.m + 1) + (p.n - p.m + 1) for p in P.precs)
    assert nb == ent * 8 + ptr * 4 + nt * nt * 4 + 2 * A.shape[0] * 4


def test_k2_counts_scanned_levels_only():
    big = level(SCAN_ABOVE + 1, SCAN_ABOVE + 3, dict(L=4, U=6, E=1, F=1))
    levels = [big] + LEVELS
    assert k2_launches(levels) == 4
    nb, fl = k2_work(levels, 3, 4)
    m = SCAN_ABOVE + 1
    assert nb == 2 * ((4 * 8 + 2 * m * 3 * 4) + (6 * 8 + 2 * m * 3 * 4))
    assert fl == 2 * 2 * 10 * 3
    assert k2_launches(LEVELS) == 0


def test_gmres_by_hand():
    mb, mf = msolve_work(LEVELS, 1, 10, 1, 8)
    nb, fl = gmres_work(LEVELS, 1, 28, 10, 3, 2, 8)
    # 3 steps in cycles of 2: 3 M-solves, 3 + 2 products with A, basis
    # steps j = 0, 1, 0
    prod = 28 * 12 + 4 * 11 + 2 * 10 * 8
    basis = ((4 * 1 + 2) + (4 * 2 + 2) + (4 * 1 + 2)) * 10 * 8
    assert nb == 3 * mb + 5 * prod + basis
    assert fl == 3 * mf + 5 * 2 * 28 + 8 * (1 + 2 + 1) * 10


def read(name, ctx):
    return spec.load_module(spec.metric_file(name)).read(ctx)


def ctx_for(kind, **kw):
    big = level(SCAN_ABOVE + 1, SCAN_ABOVE + 3, dict(L=4, U=6, E=1, F=1))
    tr = DeviceTrace(2.0, 1.5, {"trsv_solve_kernel": (1.0, 8)}, {})
    base = dict(kind=kind, levels=[big], tail_n=2, n=SCAN_ABOVE + 3,
                trace=tr, counted={"trsv_solve_kernel": 8}, nrhs=4, dtype="float32", es=4,
                solves=2, iters=[1, 1], reads=[3, 5], restart=30,
                nnz_a=40)
    base.update(kw)
    return base


def test_readers():
    ctx = ctx_for("apply")
    assert read("device_idle_pct.apply", ctx) == pytest.approx(25.0)
    nb, fl = msolve_work(ctx["levels"], 2, ctx["n"], 4, 4)
    assert read("solve_roofline.apply", ctx) == pytest.approx(
        100 * 2 * peaks.least_seconds(nb, fl, "float32") / 1.5)
    nb, fl = k2_work(ctx["levels"], 4, 4)
    assert read("k2_roofline.apply", ctx) == pytest.approx(
        100 * 2 * nb / peaks.MEM_BYTES_PER_S / 1.0)
    g = ctx_for("gmres", nrhs=1)
    assert read("gmres_iters", g) == 1.0
    assert read("host_reads_per_system", g) == 4.0
    nb1, _ = k2_work(g["levels"], 1, 4)
    assert read("k2_roofline.gmres", g) == pytest.approx(
        100 * 2 * nb1 / peaks.MEM_BYTES_PER_S)


@pytest.mark.parametrize("change", [
    dict(counted={"trsv_solve_kernel": 10}),
    dict(counted={"trsv_solve_kernel": 6}), dict(trace=None)])
def test_k2_reader_is_silent_on_a_lost_or_moved_launch(change):
    assert read("k2_roofline.apply", ctx_for("apply", **change)) is None


def test_no_device_time_reads_nothing():
    ctx = ctx_for("apply", trace=DeviceTrace(1.0, 0.0, {}, {}),
                  counted={"trsv_solve_kernel": 0})
    for name in ("device_idle_pct.apply", "solve_roofline.apply",
                 "k2_roofline.apply"):
        assert read(name, ctx) is None
    assert read("gmres_iters", dict(iters=[])) is None
    assert read("host_reads_per_system", dict(reads=[None])) is None


def test_peak_table():
    assert peaks.least_seconds(3.35e12, 0, "float32") == pytest.approx(1.0)
    assert peaks.least_seconds(0, 67e12, "float64") == pytest.approx(1.0)
    assert np.isclose(peaks.least_seconds(3.35e12, 134e12, "float32"), 2.0)
