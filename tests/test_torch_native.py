"""The port's native host library (``hifir_tpu_torch/native``).

Two kinds of check, at small sizes on the CPU:

* the port's native kernels against the port's own numpy anchors on the
  same inputs (the anchor is the spec, as in the JAX package's native
  tests, ``tests/test_factorize.py``): the Crout in modes general, LDL^T and
  LDL^H in f64, f32, c64 and c128 (real factors bit for bit; complex values
  within 1e-12 (c128) / 1e-5 (c64) of their largest magnitude, since
  ``std::complex`` and numpy round complex products differently), the
  pivoting Crout (permutations and nnz exactly, solves within 1e-12 / 1e-5,
  what ``test_native_pivot_matches_anchor`` asserts), MC64 (the same
  matching; both scalings dual feasible), AMD and RCM (permutations that
  reduce fill or bandwidth), ``permute_scale``, ``trsv`` (1e-12 / 1e-5),
  ``trsv_levels`` and ``defer_probe`` (exactly);
* the port with its library against the JAX package with its library, level
  by level: sizes, permutations and patterns exactly, values within 1e-12.
  The JAX library is built here from ``hifir_tpu/native/src`` with its
  Makefile's flags into ``build/hifir_tpu/native/`` and loaded through
  ``HIFIR_TPU_LIB`` for the test's duration.
"""

import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

import hifir_tpu.pre._native as jnative
from hifir_tpu.api import HIF as JHIF
from hifir_tpu.models import convdiff2d, poisson2d, saddle_point_stokes
from hifir_tpu.options import Options as JOptions

import hifir_tpu_torch as ht
import hifir_tpu_torch.pre._native as tnative
from hifir_tpu_torch.ds.csr import CSR
from hifir_tpu_torch.native import build
from hifir_tpu_torch.ops.trsv import _compute_levels
from hifir_tpu_torch.options import PIVOTING_ON, REORDER_RCM
from hifir_tpu_torch.pre.driver import defer_tiny_diags
from hifir_tpu_torch.pre.matching import mc64_matching
from hifir_tpu_torch.pre.ordering import run_amd, run_rcm, symmetrize_pattern

from test_torch_factorize import (CASES, OPTS, _hermitian, _shifted,
                                  assert_levels_equal)
from test_torch_prec import _port

ROOT = Path(__file__).resolve().parents[1]
JAX_SRC = ROOT / "hifir_tpu" / "native" / "src"
JAX_BUILD = ROOT / "build" / "hifir_tpu" / "native"


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def jax_lib_path():
    so, _ = build.build_library(JAX_SRC, JAX_BUILD, "libhifir_tpu")
    return str(so)


@pytest.fixture
def jax_lib(jax_lib_path, monkeypatch):
    """The JAX package with its native library loaded for the test."""
    monkeypatch.setenv("HIFIR_TPU_LIB", jax_lib_path)
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", False)
    assert jnative.available()


def _anchor(fn, *args, **kw):
    """``fn`` with the port's library switched off for the call."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnative, "_load", lambda: None)
        return fn(*args, **kw)


# -- the build -------------------------------------------------------------

def test_sources_are_copies_of_the_jax_package():
    """Each C++ source equals the JAX package's but for comment lines."""
    names = sorted(p.name for p in build.SOURCE_DIR.iterdir())
    assert names == ["amd.cpp", "analyze.cpp", "common.hpp", "crout.cpp",
                     "levels.cpp", "mc64.cpp", "permute.cpp", "rcm.cpp",
                     "trsv.cpp"]
    for name in names:
        mine = (build.SOURCE_DIR / name).read_text().splitlines()
        ref = (JAX_SRC / name).read_text().splitlines()
        assert len(mine) == len(ref), name
        for a, b in zip(mine, ref):
            assert a == b or (a.lstrip().startswith("//")
                              and b.lstrip().startswith("//")), (name, a)


def test_library_is_cached_and_keyed_by_the_host_cpu(monkeypatch):
    lib = build.load_native()
    assert lib.path == build.library_path(build.SOURCE_DIR, build.BUILD_DIR,
                                          "libhifir_native")
    assert lib.path.parent == ROOT / "build" / "hifir_tpu_torch" / "native"
    assert build.build_library(build.SOURCE_DIR, build.BUILD_DIR,
                               "libhifir_native") == (lib.path, 0.0)
    monkeypatch.setattr(build, "_host_key", lambda: "another CPU")
    assert build.library_path(build.SOURCE_DIR, build.BUILD_DIR,
                              "libhifir_native") != lib.path


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "bad.cpp").write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match=r"bad\.cpp.*error"):
        build.build_library(src, tmp_path / "out", "libbad")
    assert not list((tmp_path / "out").glob("*.so"))


def test_compiler_without_openmp_is_passed_over(monkeypatch, tmp_path):
    """A ``$CXX`` that cannot link ``-fopenmp`` (here one that does not
    exist) is passed over for ``g++``; the choice is made once a
    process."""
    build._cxx.cache_clear()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    try:
        assert build._cxx() != os.environ["CXX"]
        assert os.path.basename(build._cxx()).startswith("g++")
    finally:
        build._cxx.cache_clear()


def test_bridge_binds_every_entry_point():
    assert tnative.available() and tnative.has_crout() and tnative.has_pivot()
    for dt in (np.float32, np.float64, np.complex64, np.complex128):
        assert tnative.has_crout_dtype(dt) and tnative.has_pivot_dtype(dt)
    lib = tnative._load()
    for flag in ("_has_amd", "_has_rcm", "_has_trsv", "_has_trsv_mrhs",
                 "_has_trsv_s", "_has_trsv_mrhs_s"):
        assert getattr(lib, flag), flag


# -- native kernels against the port's anchors -----------------------------

def _crout_case(mode):
    if mode == "general":
        return _port(convdiff2d(24))
    if mode == "ldlt":
        return _port(poisson2d(20))
    if mode == "ldlh":
        return _port(_hermitian(12, True))
    if mode == "complex_symmetric":
        return _port(_hermitian(12, False))
    return _port(_shifted(convdiff2d(16)))   # complex general


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["general", "ldlt", "ldlh",
                                  "complex_symmetric", "complex_general"])
def test_native_crout_equals_anchor(mode, dtype):
    """``use_native`` 1 against 0 (only the Crout differs: MC64 and AMD are
    native in both, as in the JAX package)."""
    A = _crout_case(mode)
    o = dict(OPTS, dtype=dtype)
    M1 = ht.HIF().factorize(A, ht.Options(**o), device="cpu")
    M2 = ht.HIF().factorize(A, ht.Options(use_native=0, **o), device="cpu")
    cplx = np.iscomplexobj(A.data)
    if mode in ("ldlt", "ldlh", "complex_symmetric"):
        assert abs(M1.precs[0].L_B.to_scipy() - (
            M1.precs[0].U_B.to_scipy().conj().T if mode == "ldlh"
            else M1.precs[0].U_B.to_scipy().T)).max() == 0
    tol = 0.0 if not cplx else (1e-12 if dtype == "float64" else 1e-5)
    assert [(p.m, p.n) for p in M1.precs] == [(p.m, p.n) for p in M2.precs]
    for a, b in zip(M1.precs, M2.precs):
        for f in ("p", "q"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for f in ("L_B", "U_B", "E", "F"):
            x, y = getattr(a, f), getattr(b, f)
            np.testing.assert_array_equal(x.indptr, y.indptr)
            np.testing.assert_array_equal(x.indices, y.indices)
            assert x.data.dtype == y.data.dtype
            if x.data.size:
                assert _rel(x.data, y.data) <= tol, f
        assert _rel(a.d, b.d) <= tol
    assert M1.stats_.tolist() == M2.stats_.tolist()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_native_pivot_equals_anchor(dtype):
    A = _port(saddle_point_stokes(7))
    o = dict(verbose=0, pivot=PIVOTING_ON, dense_thres=20, dtype=dtype)
    M1 = ht.HIF().factorize(A, ht.Options(**o), device="cpu")
    M2 = ht.HIF().factorize(A, ht.Options(use_native=0, **o), device="cpu")
    assert M1.nnz() == M2.nnz()
    for a, b in zip(M1.precs, M2.precs):
        np.testing.assert_array_equal(a.p, b.p)
        np.testing.assert_array_equal(a.q, b.q)
    b = np.random.default_rng(5).standard_normal(A.nrows)
    assert _rel(M1.solve(b), M2.solve(b)) <= (1e-12 if dtype == "float64"
                                              else 1e-5)


def _check_mc64(A, p, s, t):
    """Dual feasibility: scaled matched entries 1, every scaled entry <= 1
    (``tests/test_pre.py``)."""
    D = np.abs(np.diag(s) @ A.todense() @ np.diag(t))
    np.testing.assert_allclose(D[p, np.arange(A.nrows)], 1.0, rtol=1e-10)
    assert D.max() <= 1.0 + 1e-8


@pytest.mark.parametrize("which", ["convdiff12", "random80", "stokes8"])
def test_native_mc64_equals_anchor(which):
    from hifir_tpu.models import random_sparse

    A = _port({"convdiff12": lambda: convdiff2d(12),
               "random80": lambda: random_sparse(80, 6, seed=3),
               "stokes8": lambda: saddle_point_stokes(8)}[which]())
    p1, s1, t1, i1 = tnative.mc64(A)
    p2, s2, t2, i2 = mc64_matching(A)
    np.testing.assert_array_equal(p1, p2)
    assert i1 == i2 == 0
    _check_mc64(A, p1, s1, t1)
    _check_mc64(A, p2, s2, t2)


def _bandwidth(S) -> int:
    S = S.tocoo()
    return int(np.abs(S.row - S.col).max())


def test_native_amd_and_rcm_order_well():
    """AMD (native) is a permutation with less fill than the natural and
    the RCM orders in a complete LU; RCM (native) is a permutation that
    shrinks the bandwidth of a scrambled grid."""
    p0 = np.random.default_rng(0).permutation(144)
    S = poisson2d(12).to_scipy()[p0][:, p0].tocsr()
    B = CSR.from_scipy(S)
    amd, rcm = run_amd(B), run_rcm(B)
    for perm in (amd, rcm):
        np.testing.assert_array_equal(np.sort(perm), np.arange(144))
    assert _bandwidth(S[rcm][:, rcm]) < _bandwidth(S)

    def fill(perm):
        L = np.linalg.cholesky(S[perm][:, perm].toarray())
        return int((np.abs(L) > 1e-14).sum())

    assert fill(amd) < fill(rcm) < fill(np.arange(144))
    # the scipy fallback gives a valid RCM too
    P = symmetrize_pattern(B)
    assert _bandwidth(S[_anchor(run_rcm, B)][:, _anchor(run_rcm, B)]) \
        < _bandwidth(S)
    assert tnative.rcm(P.nrows, P.indptr, P.indices) is not None


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_native_permute_scale_equals_scipy(dtype):
    A = _port(convdiff2d(10)).astype(dtype)
    rng = np.random.default_rng(1)
    n = A.nrows
    s, t = rng.random(n) + 0.5, rng.random(n) + 0.5
    p, q = rng.permutation(n), rng.permutation(n)
    q_inv = np.empty(n, dtype=np.int64)
    q_inv[q] = np.arange(n)
    Bp, Bi, Bv = tnative.permute_scale(A, s, t, p, q_inv)
    ref = (sp.diags(s) @ A.to_scipy() @ sp.diags(t)).tocsr()[p][:, q].tocsr()
    ref.sort_indices()
    got = sp.csr_matrix((Bv, Bi, Bp), shape=(n, n))
    got.sort_indices()
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.data, ref.data.astype(dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("nrhs", [0, 3])
def test_native_trsv_equals_row_loop(lower, nrhs, dtype):
    from hifir_tpu_torch.models.problems import random_strict_triangular

    T = random_strict_triangular(120, lower, seed=2).astype(dtype)
    rng = np.random.default_rng(4)
    b = rng.standard_normal((120, nrhs) if nrhs else 120).astype(dtype)
    x = (T.solve_as_strict_lower(b) if lower else
         T.solve_as_strict_upper(b))
    ref = _anchor(T.solve_as_strict_lower if lower
                  else T.solve_as_strict_upper, b)
    assert x.dtype == ref.dtype == dtype
    assert _rel(x, ref) <= (1e-12 if dtype == np.float64 else 1e-5)


@pytest.mark.parametrize("lower", [True, False])
def test_native_trsv_levels_equal_the_wavefront(lower):
    from hifir_tpu_torch.models.problems import random_strict_triangular

    T = random_strict_triangular(300, lower, nnz_per_row=3, seed=1)
    np.testing.assert_array_equal(
        tnative.trsv_levels(T.nrows, T.indptr, T.indices, lower),
        _compute_levels(T.nrows, T.indptr, T.indices, lower))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_native_defer_probe_equals_anchor(dtype):
    A = _port(saddle_point_stokes(8)).astype(dtype)
    n = A.nrows
    rng = np.random.default_rng(2)
    p, q = rng.permutation(n), rng.permutation(n)
    for pp, qq in ((np.arange(n), np.arange(n)), (p, q)):
        m1, p1, q1 = defer_tiny_diags(A, n, pp, qq)
        m2, p2, q2 = _anchor(defer_tiny_diags, A, n, pp, qq)
        assert m1 == m2
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(q1, q2)
    assert m1 < n   # the zero (2,2) block is deferred


def test_native_analysis_helpers_equal_numpy():
    """transpose, diagonal, pattern-symmetry ratio, value symmetry and the
    fused leading-block pattern against their numpy versions."""
    from hifir_tpu_torch.api import _classify_symmetry

    for A in (_port(convdiff2d(9)), _port(saddle_point_stokes(6))):
        Bp, Bi, Bv = tnative.transpose(A)
        T = A.transpose()
        np.testing.assert_array_equal(Bp, T.indptr)
        np.testing.assert_array_equal(Bi, T.indices)
        np.testing.assert_array_equal(Bv, T.data)
        np.testing.assert_array_equal(A.diagonal(), _anchor(A.diagonal))
        assert A.pattern_symm_ratio() == _anchor(A.pattern_symm_ratio)
        assert _classify_symmetry(A) == _anchor(_classify_symmetry, A)
        m = A.nrows - 7
        p = np.random.default_rng(0).permutation(A.nrows)
        q = np.random.default_rng(1).permutation(A.nrows)
        Pp, Pi = tnative.sym_leading_pattern(A, p, q, m)
        got = sp.csr_matrix((np.ones(Pi.size), Pi, Pp), shape=(m, m))
        Bm = A.to_scipy()[p[:m]][:, q[:m]]
        ref = ((Bm != 0) + (Bm != 0).T).astype(float).tocsr()
        got.sort_indices()
        ref.sort_indices()
        np.testing.assert_array_equal(got.indptr, ref.indptr)
        np.testing.assert_array_equal(got.indices, ref.indices)
    assert _classify_symmetry(_port(poisson2d(6))) == 1


def test_reorder_amd_is_amd_with_the_library():
    """``REORDER_AMD`` (the default) orders by AMD, not RCM: it factors
    with less fill than ``REORDER_RCM``, and equals RCM without the
    library."""
    A = _port(poisson2d(24))
    o = dict(OPTS, verbose=0)
    Pamd = ht.HIF().factorize(A, ht.Options(**o), device="cpu")
    Prcm = ht.HIF().factorize(A, ht.Options(reorder=REORDER_RCM, **o),
                              device="cpu")
    assert not np.array_equal(Pamd.precs[0].p, Prcm.precs[0].p)
    Pa = _anchor(ht.HIF().factorize, A, ht.Options(**o), device="cpu")
    Pr = _anchor(ht.HIF().factorize, A,
                 ht.Options(reorder=REORDER_RCM, **o), device="cpu")
    np.testing.assert_array_equal(Pa.precs[0].p, Pr.precs[0].p)


# -- the port with its library against the JAX package with its library ---

_WITH_LIB = dict(CASES)
_WITH_LIB.update({
    "convdiff32": lambda: (convdiff2d(32), dict(verbose=0), 0),
    "poisson32": lambda: (poisson2d(32), dict(verbose=0), 0),
    "stokes8": lambda: (saddle_point_stokes(8), dict(verbose=0), 0),
})


@pytest.mark.parametrize("case", sorted(_WITH_LIB))
def test_port_with_library_equals_jax_with_library(case, jax_lib):
    A, o, m0 = _WITH_LIB[case]()
    jo = JOptions(**o)
    J = JHIF().factorize(A, jo, m0)
    P = ht.HIF().factorize(_port(A), ht.Options(**dataclasses.asdict(jo)),
                           m0, device="cpu")
    assert_levels_equal(P, J)
    assert [P.stats(i) for i in range(6)] == [J.stats(i) for i in range(6)]
    b = np.random.default_rng(0).standard_normal(A.nrows)
    if np.iscomplexobj(A.data):
        b = b + 1j * np.random.default_rng(1).standard_normal(A.nrows)
    for trans in (False, True):
        assert _rel(P.solve(b, trans=trans), J.solve(b, trans=trans)) <= 1e-12


def test_use_native_0_keeps_native_matching_and_ordering(jax_lib):
    """``use_native=0`` switches only the Crout kernels off, in both
    packages: AMD and MC64 still come from the library."""
    A = convdiff2d(20)
    jo = JOptions(**dict(OPTS, use_native=0))
    J = JHIF().factorize(A, jo)
    P = ht.HIF().factorize(_port(A), ht.Options(**dataclasses.asdict(jo)),
                           device="cpu")
    assert_levels_equal(P, J)
    Pa = _anchor(ht.HIF().factorize, _port(A),
                 ht.Options(**dataclasses.asdict(jo)), device="cpu")
    assert not np.array_equal(Pa.precs[0].p, P.precs[0].p)


def test_pins_switch_the_libraries_off_and_back(jax_lib):
    assert os.environ["HIFIR_TPU_LIB"].startswith(str(JAX_BUILD))
    assert _anchor(tnative.available) is False
    assert tnative.available() and jnative.available()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_load", lambda: None)
        assert not jnative.available()
    assert jnative.available()
