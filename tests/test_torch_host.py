"""The port's host solves, IO and problem generators against the JAX
package's, at small sizes on the CPU.

The operators are factorized by the JAX package and carried across with
``save_prec`` -> ``prec_from_arrays`` (``tests/test_torch_prec.py``), so
that both packages apply the same preconditioner; the port's host
triangular solves run in its native library (real factors), the JAX
package's in numpy (its library is not built here).  Host results must
agree within 1e-12 relative to their largest magnitude; GMRES flags and
iteration counts exactly.  The port's host solve must also equal its own
CPU pack solve (``DevicePrec`` with the plain kernel versions) within
1e-10, the tolerance of ``tests/test_torch_prec.py``.
"""

import numpy as np
import pytest

from hifir_tpu.api import HIF as JHIF
from hifir_tpu.models import problems as jproblems
from hifir_tpu.nsp import NspFilter as JNspFilter
from hifir_tpu.options import Options
from hifir_tpu.solvers.gmres_np import fgmres_hifir as jfgmres
from hifir_tpu.solvers.gmres_np import gmres_hif as jgmres
from hifir_tpu.utils import io as jio
from hifir_tpu.utils.serialize import load_prec as jload_prec

import hifir_tpu_torch as ht
from hifir_tpu_torch.alg.prec import DevicePrec
from hifir_tpu_torch.models import problems as tproblems
from hifir_tpu_torch.small_scale.dense import LUP, QRCP, SYEIG
from hifir_tpu_torch.solvers.gmres_np import fgmres_hifir, gmres_hif
from hifir_tpu_torch.utils import io as tio

from test_torch_factorize import _shifted
from test_torch_prec import _carry, _port, _rel

OPTS = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5,
            kappa_d=5, verbose=0)
_PROBLEMS = {
    "convdiff16": lambda: (jproblems.convdiff2d(16), dict(dense_thres=30)),
    "stokes8": lambda: (jproblems.saddle_point_stokes(8),
                        dict(dense_thres=30)),
    "poisson12_syeig": lambda: (jproblems.poisson2d(12), dict()),
    "shifted12_c128": lambda: (_shifted(jproblems.convdiff2d(12)),
                               dict(dense_thres=30)),
}


@pytest.fixture(scope="module", params=sorted(_PROBLEMS))
def pair(request, tmp_path_factory):
    """(A, JAX HIF, the port's HIF of the same levels, B)."""
    A, extra = _PROBLEMS[request.param]()
    J = JHIF().factorize(A, Options(**OPTS, **extra))
    P = ht.HIF(_carry(J, tmp_path_factory.mktemp(request.param)))
    rng = np.random.default_rng(3)
    B = rng.standard_normal((A.nrows, 4))
    if np.iscomplexobj(A.data):
        B = B + 1j * rng.standard_normal((A.nrows, 4))
    return A, J, P, B


@pytest.mark.parametrize("trans", [False, True])
def test_host_solve_equals_jax(pair, trans):
    A, J, P, B = pair
    x = P.solve(B[:, 0], trans=trans)
    assert x.dtype == J.solve(B[:, 0], trans=trans).dtype
    assert _rel(x, J.solve(B[:, 0], trans=trans)) <= 1e-12


@pytest.mark.parametrize("trans", [False, True])
def test_host_solve_mrhs_equals_jax_and_columns(pair, trans):
    A, J, P, B = pair
    X = P.solve_mrhs(B, trans=trans)
    assert _rel(X, J.solve_mrhs(B, trans=trans)) <= 1e-12
    for k in range(B.shape[1]):
        assert _rel(X[:, k], P.solve(B[:, k], trans=trans)) <= 1e-12


def test_host_solve_equals_cpu_pack(pair):
    A, J, P, B = pair
    dp = DevicePrec.from_host(P.precs, dtype=B.dtype, device="cpu")
    dp.pack_transpose(P.precs)
    for trans in (False, True):
        assert _rel(dp.solve_mrhs(B, trans=trans),
                    P.solve_mrhs(B, trans=trans)) <= 1e-10


def test_host_solve_rank_truncation(pair):
    A, J, P, B = pair
    r = max(P.schur_rank() - 2, 1)
    for trans in (False, True):
        assert _rel(P.solve(B[:, 1], trans=trans, r=r),
                    J.solve(B[:, 1], trans=trans, r=r)) <= 1e-12


@pytest.mark.parametrize("trans", [False, True])
def test_host_mmultiply_equals_jax_and_inverts_the_solve(pair, trans):
    A, J, P, B = pair
    y = P.mmultiply(B[:, 2], trans=trans)
    assert _rel(y, J.mmultiply(B[:, 2], trans=trans)) <= 1e-12
    if P.schur_rank() == P.schur_size():   # full rank: M (M^-1 b) = b
        assert _rel(P.mmultiply(P.solve(B[:, 2], trans=trans), trans=trans),
                    B[:, 2]) <= 1e-9


@pytest.mark.parametrize("betas", [None, (1e-10, 1e6)])
def test_host_hifir_equals_jax(pair, betas):
    A, J, P, B = pair
    got = P.hifir(_port(A), B[:, 0], 3, betas=betas)
    ref = J.hifir(A, B[:, 0], 3, betas=betas)
    if betas is None:
        assert _rel(got, ref) <= 1e-12
    else:
        assert got[1:] == ref[1:]
        assert _rel(got[0], ref[0]) <= 1e-12


def test_host_hifir_boost_and_callback_equal_jax(pair):
    A, J, P, B = pair
    got = P.hifir(_port(A), B[:, 1], 3, boost=True)
    assert _rel(got, J.hifir(A, B[:, 1], 3, boost=True)) <= 1e-12
    got = P.hifir(_port(A).matvec, B[:, 1], 2, trans=False, boost=True)
    assert _rel(got, J.hifir(A.matvec, B[:, 1], 2, boost=True)) <= 1e-12


def test_host_gmres_equals_jax(pair):
    A, J, P, B = pair
    b = B[:, 0]
    x, flag, it = gmres_hif(_port(A), P, b, restart=10, rtol=1e-8)
    xj, flagj, itj = jgmres(A, J, b, restart=10, rtol=1e-8)
    assert (flag, it) == (flagj, itj) and flag == 0
    assert _rel(x, xj) <= 1e-10
    res = np.linalg.norm(b - A.to_scipy() @ x) / np.linalg.norm(b)
    assert res <= 1.01e-8


@pytest.mark.parametrize("name", ["convdiff16", "stokes8", "poisson12_syeig"])
def test_host_fgmres_hifir_equals_jax(name, tmp_path):
    """fgmres_hifir (real only, as in the JAX package) with the tail's
    rank."""
    A, extra = _PROBLEMS[name]()
    J = JHIF().factorize(A, Options(**OPTS, **extra))
    P = ht.HIF(_carry(J, tmp_path))
    b = np.random.default_rng(4).standard_normal(A.nrows)
    r = P.schur_rank()
    x, flag, it, nmv = fgmres_hifir(_port(A), P, b, restart=10, rtol=1e-8,
                                    rank=r)
    xj, flagj, itj, nmvj = jfgmres(A, J, b, restart=10, rtol=1e-8, rank=r)
    assert (flag, it, nmv) == (flagj, itj, nmvj) and flag == 0
    assert _rel(x, xj) <= 1e-10


def test_host_nsp_filter_equals_jax(monkeypatch):
    """A singular system: the constant-mode filter on the host solve.  The
    port's library is switched off, so that both packages run the same
    numpy triangular solves: on this system M^{-1} magnifies the rounding
    of a reordered sum (the native trsv's) to ~1e-11 of max|x|."""
    import hifir_tpu_torch.pre._native as tnative
    from test_torch_factorize import singular_matrix

    monkeypatch.setattr(tnative, "_load", lambda: None)
    A = singular_matrix()
    J = JHIF().factorize(A, Options(verbose=0, dense_thres=50))
    P = ht.HIF(ht.prec_from_arrays(_arrays(J)))
    J.nsp, P.nsp = JNspFilter(), ht.NspFilter()
    J.nsp_tran, P.nsp_tran = JNspFilter(0, 20), ht.NspFilter(0, 20)
    b = np.random.default_rng(0).standard_normal(A.nrows)
    for trans in (False, True):
        x = P.solve(b, trans=trans)
        assert _rel(x, J.solve(b, trans=trans)) <= 1e-12
    assert abs(P.solve(b).mean()) <= 1e-12 * np.abs(P.solve(b)).max()
    with pytest.raises(RuntimeError, match="null-space"):
        P.solve_mrhs(b[:, None])


def _arrays(M) -> dict:
    """The ``save_prec`` payload of a JAX HIF, in memory."""
    import io

    from hifir_tpu.utils.serialize import save_prec

    buf = io.BytesIO()
    save_prec(buf, M)
    buf.seek(0)
    with np.load(buf) as z:
        return dict(z)


def test_empty_preconditioner_raises():
    P = ht.HIF()
    for call in (lambda: P.solve(np.ones(3)), lambda: P.mmultiply(np.ones(3)),
                 lambda: P.solve_mrhs(np.ones((3, 1)))):
        with pytest.raises(RuntimeError, match="empty"):
            call()


@pytest.mark.parametrize("kind", ["qrcp", "syeig", "lup"])
def test_dense_tail_solve_and_multiply_equal_jax(kind):
    from hifir_tpu.small_scale import dense as jdense

    rng = np.random.default_rng(1)
    G = rng.standard_normal((12, 12))
    M = G + G.T if kind == "syeig" else G
    mine = {"qrcp": QRCP, "syeig": SYEIG, "lup": LUP}[kind]()
    ref = {"qrcp": jdense.QRCP, "syeig": jdense.SYEIG,
           "lup": jdense.LUP}[kind]()
    mine.factorize(M)
    ref.factorize(M)
    y = rng.standard_normal((12, 3))
    for trans in (False, True):
        for v in (y, y[:, 0]):
            assert _rel(mine.solve(v, 0, trans), ref.solve(v, 0, trans)) \
                <= 1e-12
        assert _rel(mine.multiply(y[:, 0], trans),
                    ref.multiply(y[:, 0], trans)) <= 1e-12
    if kind != "lup":
        assert _rel(mine.solve(y, 7), ref.solve(y, 7)) <= 1e-12


# -- serialization and IO --------------------------------------------------

def test_port_save_prec_reads_in_jax(tmp_path):
    """The port's own factorize (native library) saved by the port's
    ``save_prec``, loaded by the JAX ``load_prec``: the same levels, and
    the JAX host solve equals the port's."""
    A = tproblems.convdiff2d(20)
    P = ht.HIF().factorize(A, ht.Options(**OPTS, dense_thres=40),
                           device="cpu")
    path = tmp_path / "port_prec.npz"
    ht.save_prec(str(path), P)
    J = jload_prec(str(path))
    assert [(p.m, p.n) for p in J.precs] == [(p.m, p.n) for p in P.precs]
    assert J.stats_.tolist() == P.stats_.tolist()
    assert J.precs[-1].dense_solver.kind == P.precs[-1].dense_solver.kind
    b = np.random.default_rng(2).standard_normal(A.nrows)
    for trans in (False, True):
        assert _rel(P.solve(b, trans=trans), J.solve(b, trans=trans)) <= 1e-12
    Q = ht.load_prec(str(path))
    assert Q.stats_.tolist() == P.stats_.tolist()
    assert _rel(Q.solve(b), P.solve(b)) <= 1e-12


@pytest.mark.parametrize("cplx", [False, True])
def test_matrix_market_round_trips_both_ways(tmp_path, cplx):
    A = jproblems.random_sparse(30, 4, seed=1,
                                dtype=np.complex128 if cplx else np.float64)
    T = _port(A)
    f1, f2 = tmp_path / "port.mtx", tmp_path / "jax.mtx.gz"
    tio.write_mm(str(f1), T)
    jio.write_mm(str(f2), A)
    for got in (jio.read_mm(str(f1)), tio.read_mm(str(f2)),
                tio.read_mm(str(f1))):
        for g in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(got, g), getattr(A, g))
    assert tio.query_mm(str(f1)) == jio.query_mm(str(f1))
    v = A.data[:30]
    tio.write_mm_vector(str(tmp_path / "v.mtx"), v)
    np.testing.assert_array_equal(jio.read_mm_vector(str(tmp_path / "v.mtx")),
                                  v)
    np.testing.assert_array_equal(tio.read_mm_vector(str(tmp_path / "v.mtx")),
                                  v)


def test_matrix_market_symmetric_and_native_binary(tmp_path):
    f = tmp_path / "sym.mtx"
    f.write_text("%%MatrixMarket matrix coordinate real symmetric\n"
                 "3 3 4\n1 1 2.0\n2 1 -1.0\n3 2 -1.5\n3 3 4.0\n")
    got, ref = tio.read_mm(str(f)), jio.read_mm(str(f))
    np.testing.assert_array_equal(got.todense(), ref.todense())
    assert got.todense()[0, 1] == -1.0
    A = _port(jproblems.convdiff2d(6))
    tio.write_native(str(tmp_path / "a.npz"), A)
    B = jio.read_native(str(tmp_path / "a.npz"))
    jio.write_native(str(tmp_path / "b.npz"), B)
    C = tio.read_native(str(tmp_path / "b.npz"))
    for g in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(C, g), getattr(A, g))


_GENERATORS = {
    "poisson2d": (lambda m: m.poisson2d(7, 5)),
    "poisson3d": (lambda m: m.poisson3d(4, 3, 5)),
    "convdiff2d": (lambda m: m.convdiff2d(6, wind=(-3.0, 5.0))),
    "saddle_point_stokes": (lambda m: m.saddle_point_stokes(6, seed=4)),
    "random_sparse": (lambda m: m.random_sparse(40, 5, seed=2,
                                                dtype=np.complex128)),
    "random_strict_triangular": (lambda m: m.random_strict_triangular(
        30, False, seed=3)),
}


@pytest.mark.parametrize("name", sorted(_GENERATORS))
def test_problem_generators_equal_jax(name):
    got, ref = (_GENERATORS[name](m) for m in (tproblems, jproblems))
    assert got.shape == ref.shape
    for g in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, g), getattr(ref, g))


def test_port_factorize_solves_saddle_point_ir():
    """bench.py's correctness leg at a small size: mixed f32-M / f64
    residual Richardson on saddle_point_stokes with the port's factorize
    (native library) and its CPU pack; the residual contracts."""
    A = tproblems.saddle_point_stokes(16)
    P = ht.HIF().factorize(A, ht.Options(verbose=0), device="cpu")
    dp = P.to_device(dtype=np.float32, device="cpu")
    b = np.random.default_rng(0).standard_normal(A.nrows)
    x = np.zeros_like(b)
    res = [np.linalg.norm(b)]
    for _ in range(5):
        r = b - A.matvec(x)
        x = x + dp.solve_mrhs(r[:, None].astype(np.float32)).numpy()[:, 0]
        res.append(np.linalg.norm(b - A.matvec(x)))
    ratios = np.array(res[1:]) / np.array(res[:-1])
    assert np.median(ratios) < 0.5
    assert res[-1] < 1e-3 * res[0]
