"""The port's own factorize against the JAX package's, level by level.

Every factorize here runs with both packages' native host libraries
switched off (``hifir_tpu.pre._native._load`` and
``hifir_tpu_torch.pre._native._load`` return None), so that both run the
same numpy anchors: MC64 matching, RCM in place of AMD, the Crout anchors
and scipy's Schur complement, as the checked-in fixtures were written.
With a library the package takes AMD, the native MC64 and the C++ Crout;
``tests/test_torch_native.py`` holds the two libraries against each other.  Tolerances: permutations and
sparsity patterns exactly, values (L_B, U_B, E, F, d, s, t, the dense Schur)
within 1e-12 relative to their largest magnitude; f64 solves within 1e-10
relative to max|X| (``tests/test_device.py``'s tolerance).
"""

import dataclasses
import os

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

import hifir_tpu.pre._native as jnative
from hifir_tpu.alg.prec import DevicePrec as JDevicePrec
from hifir_tpu.api import HIF as JHIF
from hifir_tpu.ds.csr import CSR as JCSR
from hifir_tpu.ds.csr import csr_from_dense
from hifir_tpu.models import (convdiff2d, poisson2d, random_sparse,
                              saddle_point_stokes)
from hifir_tpu.options import PIVOTING_ON
from hifir_tpu.options import Options as JOptions

import hifir_tpu_torch as ht
import hifir_tpu_torch.pre._native as tnative
from hifir_tpu_torch import options as toptions

from test_torch_prec import _port, _rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "hifir_tpu_torch", "data",
                       "convdiff2d_128_prec.npz")
CPU = "cpu"
OPTS = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5, kappa_d=5,
            verbose=0)
# the checked-in nonsymmetric fixture's options (its docstring in
# tests/test_torch_surface.py has the command that wrote it)
FIXTURE_OPTS = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=3,
                    kappa_d=3, dense_thres=600, verbose=0)


def jax_factorize(A, opts: JOptions, m0: int = 0):
    """The JAX package's factorize on its numpy anchors (native library
    switched off for the call)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_load", lambda: None)
        return JHIF().factorize(A, opts, m0)


def port_factorize(A, opts: JOptions, m0: int = 0, **kw):
    """The port's factorize of the same operator with the same options, on
    its numpy anchors (native library switched off for the call)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnative, "_load", lambda: None)
        return ht.HIF().factorize(_port(A),
                                  ht.Options(**dataclasses.asdict(opts)),
                                  m0, **kw)


def _shifted(A) -> JCSR:
    """``A + (-0.1 + 0.1i) diag(|a_ii|)`` in complex128."""
    S = A.to_scipy().astype(np.complex128)
    return JCSR.from_scipy(S + (-0.1 + 0.1j) * sp.diags(np.abs(S.diagonal())))


def _hermitian(nx: int, herm: bool) -> JCSR:
    """Complex Poisson-like operator, Hermitian when ``herm``, else complex
    symmetric (``tests/test_factorize.py``'s ``_hermitian_test_matrix``)."""
    A = poisson2d(nx).to_scipy().astype(np.complex128).tolil()
    rng = np.random.default_rng(3)
    rows, cols = A.nonzero()
    for r, c in zip(rows, cols):
        if r < c:
            v = complex(A[r, c]) + 1j * 0.3 * rng.standard_normal()
            A[r, c] = v
            A[c, r] = np.conj(v) if herm else v
    return JCSR.from_scipy(A.tocsr())


def singular_matrix() -> JCSR:
    """The singular system of ``tests/test_torch_surface.py``'s ``singular``
    fixture: a centered SPD matrix, whose null space is the constant
    vector."""
    rng = np.random.default_rng(5)
    n = 40
    G = rng.standard_normal((n, n))
    D = G @ G.T
    D -= np.outer(D.sum(1), np.ones(n)) / n
    D -= np.outer(np.ones(n), D.sum(0)) / n
    return csr_from_dense(D, tol=1e-14)


# name -> (operator, options, m0)
CASES = {
    "poisson20_ldlt": lambda: (poisson2d(20), dict(verbose=0), 0),
    "convdiff24": lambda: (convdiff2d(24), dict(OPTS, dense_thres=120), 0),
    "convdiff16_shifted_c128": lambda: (_shifted(convdiff2d(16)),
                                        dict(OPTS, dense_thres=30), 0),
    "hermitian12": lambda: (_hermitian(12, True), dict(OPTS), 0),
    "cplx_symmetric12": lambda: (_hermitian(12, False), dict(OPTS), 0),
    "random70_pivot_on": lambda: (random_sparse(70, 6, seed=0),
                                  dict(verbose=0, pivot=PIVOTING_ON,
                                       dense_thres=20), 0),
    "convdiff24_float32": lambda: (convdiff2d(24),
                                   dict(OPTS, dense_thres=120,
                                        dtype="float32"), 0),
    "stokes8_m0_block": lambda: (saddle_point_stokes(8),
                                 dict(OPTS, dense_thres=30), 64),
    "singular40": lambda: (singular_matrix(), dict(verbose=0,
                                                   dense_thres=50), 0),
}


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.size:
        assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


def assert_levels_equal(P, J):
    """The port's HIF ``P`` level by level against the JAX package's ``J``
    (or a loaded reference): sizes, permutations and patterns exactly,
    values within 1e-12, the tail's kind and rank, and the statistics."""
    assert [(p.m, p.n) for p in P.precs] == [(p.m, p.n) for p in J.precs]
    for pp, jp in zip(P.precs, J.precs):
        for f in ("p", "q", "p_inv", "q_inv"):
            np.testing.assert_array_equal(getattr(pp, f), getattr(jp, f))
        for f in ("L_B", "U_B", "E", "F"):
            a, b = getattr(pp, f), getattr(jp, f)
            assert a.shape == b.shape, f
            np.testing.assert_array_equal(a.indptr, b.indptr)
            np.testing.assert_array_equal(a.indices, b.indices)
            _close(a.data, b.data)
        for f in ("d", "s", "t"):
            _close(getattr(pp, f), getattr(jp, f))
    pl, jl = P.precs[-1], J.precs[-1]
    assert (pl.dense_matrix is None) == (jl.dense_matrix is None)
    if jl.dense_matrix is not None:
        _close(pl.dense_matrix, jl.dense_matrix)
        pd, jd = pl.dense_solver, jl.dense_solver
        assert (pd.kind, pd.rank, pd.n) == (jd.kind, jd.rank, jd.n)
    assert P.nnz() == J.nnz()


@pytest.mark.parametrize("case", sorted(CASES))
def test_factorize_levels_equal_jax(case):
    A, o, m0 = CASES[case]()
    jo = JOptions(**o)
    J = jax_factorize(A, jo, m0)
    P = port_factorize(A, jo, m0)
    assert_levels_equal(P, J)
    assert [P.stats(i) for i in range(6)] == [J.stats(i) for i in range(6)]
    assert (P.levels(), P.rank(), P.schur_rank(), P.schur_size(),
            P.nnz_ef(), P.nnz_ldu()) == (J.levels(), J.rank(), J.schur_rank(),
                                         J.schur_size(), J.nnz_ef(),
                                         J.nnz_ldu())


def test_factorize_takes_the_ldlt_path_on_symmetric_input():
    """symm_detect engages the one-sided kernel: L_B = U_B^T on poisson."""
    P = port_factorize(poisson2d(12), JOptions(verbose=0))
    p0 = P.precs[0]
    assert abs(p0.L_B.to_scipy() - p0.U_B.to_scipy().T).max() == 0
    assert P.precs[-1].dense_solver.kind == "syeig"


def test_convdiff_fixture_reproduced(monkeypatch):
    """The port's factorize of convdiff2d(128) with the fixture's options
    equals ``hifir_tpu_torch/data/convdiff2d_128_prec.npz``, which the JAX
    package wrote without its native library."""
    from hifir_tpu_torch.models.problems import convdiff2d as tconvdiff2d

    monkeypatch.setattr(tnative, "_load", lambda: None)
    P = ht.HIF().factorize(tconvdiff2d(128), ht.Options(**FIXTURE_OPTS))
    assert [(p.m, p.n) for p in P.precs] == [(13883, 16384), (2298, 2501)]
    assert P.nnz() == 220815
    assert_levels_equal(P, ht.load_prec(FIXTURE))


@pytest.fixture(scope="module")
def convdiff_pair():
    A = convdiff2d(24)
    jo = JOptions(**dict(OPTS, dense_thres=120))
    J = jax_factorize(A, jo)
    P = port_factorize(A, jo)
    B = np.random.default_rng(7).standard_normal((A.nrows, 4))
    return J, P, B


@pytest.mark.parametrize("dense_inv", ["auto", 0, 16])
def test_solves_from_port_factorize_match_jax(convdiff_pair, dense_inv):
    """Forward and adjoint f64 solves of the port's own factorize, packed on
    the CPU, against the JAX device solves of the JAX factorize."""
    J, P, B = convdiff_pair
    dp = P.to_device(dtype=np.float64, device=CPU, dense_inv=dense_inv)
    dp.pack_transpose(P.precs)
    jdp = JDevicePrec.from_host(J.precs, dense_inv=dense_inv)
    jdp.pack_transpose(J.precs, dtype=jnp.float64)
    for trans in (False, True):
        X = dp.solve_mrhs(B, trans=trans)
        assert _rel(X, jdp.solve_mrhs(jnp.asarray(B), trans=trans)) <= 1e-10
        assert _rel(X, J.solve_mrhs(B, trans=trans)) <= 1e-10
        x = dp.solve(B[:, 0], trans=trans)
        assert _rel(x, jdp.solve(jnp.asarray(B[:, 0]), trans=trans)) <= 1e-10


def test_options_copy_field_for_field():
    jo = JOptions(tau_L=3e-3, pivot=PIVOTING_ON, dtype="float32",
                  dense_defer=0)
    o = ht.Options(**dataclasses.asdict(jo))
    assert dataclasses.asdict(o) == dataclasses.asdict(jo)
    assert [f.name for f in dataclasses.fields(o)] == \
        [f.name for f in dataclasses.fields(jo)]
    assert o.to_stream() == jo.to_stream()
    # the stream holds the reference fields without ``pivot``
    assert dataclasses.asdict(ht.Options.from_stream(jo.to_stream())) == \
        dataclasses.asdict(JOptions.from_stream(jo.to_stream()))
    from hifir_tpu.options import determine_fac_pars as jdet

    for lvl in (1, 2, 3):
        assert toptions.determine_fac_pars(o, lvl) == jdet(jo, lvl)
    assert o.repr_options() == jo.repr_options()
    assert o.clone() == o and o.clone() is not o
    assert o.set("kappa", "7") is False and o.kappa == 7.0
    assert o.set("no_such_option", 1) is True
    with pytest.raises(KeyError):
        o.set_options(no_such_option=1)
    for name in ("VERBOSE_INFO", "REORDER_AMD", "REORDER_RCM",
                 "PIVOTING_AUTO"):
        assert getattr(toptions, name) == getattr(
            __import__("hifir_tpu.options", fromlist=[name]), name)


def test_factorize_raw_and_clear(monkeypatch):
    monkeypatch.setattr(tnative, "_load", lambda: None)
    A = convdiff2d(10)
    jo = JOptions(**dict(OPTS, dense_thres=30))
    P = ht.HIF().factorize_raw(A.nrows, A.indptr + 1, A.indices + 1, A.data,
                               ht.Options(**dataclasses.asdict(jo)))
    assert_levels_equal(P, jax_factorize(A, jo))
    P.clear()
    assert P.empty() and P.levels() == 0 and P.stats(0) == 0


def test_csr_copies_equal_reference():
    """The CSR methods the factorize calls, against the JAX package's."""
    from hifir_tpu_torch.ds.csr import csr_from_dense as tcsr_from_dense

    A = random_sparse(50, 6, seed=2)
    T = _port(A)
    x = np.random.default_rng(0).standard_normal((50, 3))
    np.testing.assert_array_equal(T.matvec(x), A.matvec(x))
    np.testing.assert_array_equal(T.matvec(x[:, 0]), A.matvec(x[:, 0]))
    np.testing.assert_array_equal(T.diagonal(), A.diagonal())
    np.testing.assert_array_equal(T.todense(), A.todense())
    assert T.pattern_symm_ratio() == A.pattern_symm_ratio()
    for m in (0, 17, 50):
        a, b = T.extract_leading(m), A.extract_leading(m)
        for g in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(a, g), getattr(b, g))
    D = A.todense()
    a, b = tcsr_from_dense(D, tol=0.5), csr_from_dense(D, tol=0.5)
    for g in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, g), getattr(b, g))
    T.check_validity()
    bad = _port(A)
    bad.indices = bad.indices[::-1].copy()
    with pytest.raises(RuntimeError, match="sorted/unique|out of bounds"):
        bad.check_validity()
