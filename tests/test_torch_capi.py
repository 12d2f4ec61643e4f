"""The port's handle API (``hifir_tpu_torch/capi.py``) against the JAX
package's (``hifir_tpu/capi.py``), on the matrices of
``tests/test_api_capi.py``.

Both packages factorize with their native libraries (the ``jax_lib``
fixture of ``tests/test_torch_native.py``).  Every apply mode and the
iterative refinement with and without ``betas`` give the same iteration
counts and flags, and x within 1e-12 of max|x|; mixed precision within
1e-5; the sparsifier, ``update`` and ``refactorize`` as the JAX handles;
the stats and size getters equal.
"""

import numpy as np
import pytest

from hifir_tpu import capi as jcapi
from hifir_tpu.models import convdiff2d, poisson2d
from hifir_tpu.options import Options as JOptions

from hifir_tpu_torch import capi
from hifir_tpu_torch.options import Options

from test_torch_native import jax_lib, jax_lib_path  # noqa: F401
from test_torch_prec import _port


def _close(x, jx, tol):
    jx = np.asarray(jx)
    np.testing.assert_allclose(np.asarray(x), jx, rtol=0,
                               atol=tol * np.abs(jx).max())


def _handles(A, S=None, precision="double", **opts):
    """The same handle in both packages, set up."""
    o = dict(verbose=0, **opts)
    jh = jcapi.create(A=A, S=S, params=JOptions(**o), precision=precision)
    h = capi.create(A=_port(A), S=None if S is None else _port(S),
                    params=Options(**o), precision=precision, device="cpu")
    jcapi.setup(jh)
    capi.setup(h)
    return h, jh


def _assert_getters_equal(h, jh):
    assert capi.empty(h) == jcapi.empty(jh)
    np.testing.assert_array_equal(capi.get_stats(h), jcapi.get_stats(jh))
    for f in ("get_nnz", "get_levels", "get_schur_size", "get_schur_rank",
              "is_mixed"):
        assert getattr(capi, f)(h) == getattr(jcapi, f)(jh), f


# apply mode -> (op, nirs, betas)
MODES = {
    "S": (capi.OP_S, 1, None),
    "SH": (capi.OP_SH, 1, None),
    "M": (capi.OP_M, 1, None),
    "MH": (capi.OP_MH, 1, None),
    "S IR": (capi.OP_S, 4, None),
    "SH IR": (capi.OP_SH, 4, None),
    "S IR betas": (capi.OP_S, 50, (1e-11, 1e8)),
    "SH IR betas": (capi.OP_SH, 50, (1e-11, 1e8)),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("problem", ["poisson14", "convdiff14"])
def test_apply_modes_match_jax(problem, mode, jax_lib):  # noqa: F811
    A = poisson2d(14) if problem == "poisson14" else convdiff2d(
        14, wind=(1.0, 2.0))
    h, jh = _handles(A)
    _assert_getters_equal(h, jh)
    op, nirs, betas = MODES[mode]
    assert op == getattr(jcapi, "OP_" + mode.split()[0])
    b = np.random.default_rng(0).standard_normal(A.nrows)
    x, iters, flag = capi.apply(h, op, b, nirs=nirs, betas=betas)
    jx, jiters, jflag = jcapi.apply(jh, op, b, nirs=nirs, betas=betas)
    assert (iters, flag) == (jiters, jflag)
    _close(x, jx, 1e-12)
    if betas is not None:
        assert flag == 0
        D = A.todense()
        Ax = (D if op == capi.OP_S else D.T) @ x
        assert np.linalg.norm(b - Ax) / np.linalg.norm(b) <= 1e-10
    capi.destroy(h)
    jcapi.destroy(jh)
    with pytest.raises(Exception):
        capi.get_levels(h)


@pytest.mark.parametrize("trans", [False, True])
def test_solve_and_solve_mrhs_match_jax(trans, jax_lib):  # noqa: F811
    A = convdiff2d(14, wind=(1.0, 2.0))
    h, jh = _handles(A)
    B = np.random.default_rng(1).standard_normal((A.nrows, 3))
    _close(capi.solve(h, B[:, 0], trans=trans),
           jcapi.solve(jh, B[:, 0], trans=trans), 1e-12)
    X = capi.solve_mrhs(h, B, trans=trans)
    _close(X, jcapi.solve_mrhs(jh, B, trans=trans), 1e-12)
    _close(X[:, 1], capi.solve(h, B[:, 1], trans=trans), 1e-12)


def test_mixed_precision_matches_jax(jax_lib):  # noqa: F811
    """Single-precision M inside a double system (ref lhfsdApply)."""
    A = poisson2d(14)
    h, jh = _handles(A, precision="mixed")
    assert capi.is_mixed(h) and jcapi.is_mixed(jh)
    _assert_getters_equal(h, jh)
    b = np.random.default_rng(1).standard_normal(A.nrows)
    x, iters, flag = capi.apply(h, capi.OP_S, b, nirs=60, betas=(1e-12, 1e8))
    jx, jiters, jflag = jcapi.apply(jh, capi.OP_S, b, nirs=60,
                                    betas=(1e-12, 1e8))
    assert flag == jflag == 0
    assert abs(iters - jiters) <= 1
    _close(x, jx, 1e-5)
    assert np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b) <= 1e-12
    x1, _, _ = capi.apply(h, capi.OP_S, b)
    jx1, _, _ = jcapi.apply(jh, capi.OP_S, b)
    _close(x1, jx1, 1e-5)


def test_sparsifier_matches_jax(jax_lib):  # noqa: F811
    """S = poisson2d(16) preconditions A = convdiff2d(16)
    (ref demo_sparsifier.cpp)."""
    A = convdiff2d(16, wind=(1.0, 2.0))
    S = poisson2d(16)
    h, jh = _handles(A, S)
    _assert_getters_equal(h, jh)
    b = np.ones(A.nrows)
    x, iters, flag = capi.apply(h, capi.OP_S, b, nirs=200,
                                betas=(1e-10, 1e8))
    jx, jiters, jflag = jcapi.apply(jh, capi.OP_S, b, nirs=200,
                                    betas=(1e-10, 1e8))
    assert (iters, flag) == (jiters, jflag) and flag == 0
    _close(x, jx, 1e-12)
    assert np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b) <= 1e-10


def test_update_and_refactorize_match_jax(jax_lib):  # noqa: F811
    A = poisson2d(12)
    h, jh = _handles(A)
    A2 = convdiff2d(12, wind=(1.0, 2.0))
    capi.update(h, _port(A2))
    jcapi.update(jh, A2)
    _assert_getters_equal(h, jh)     # the factor stays
    b = np.ones(A2.nrows)
    x, iters, flag = capi.apply(h, capi.OP_S, b, nirs=300, betas=(1e-8, 1e8))
    jx, jiters, jflag = jcapi.apply(jh, capi.OP_S, b, nirs=300,
                                    betas=(1e-8, 1e8))
    assert (iters, flag) == (jiters, jflag) and flag == 0
    _close(x, jx, 1e-12)
    capi.refactorize(h, _port(A2))
    jcapi.refactorize(jh, A2)
    assert not capi.empty(h)
    _assert_getters_equal(h, jh)
    _close(capi.solve(h, b), jcapi.solve(jh, b), 1e-12)


def test_handle_errors_match_jax():
    """An unknown handle and an empty preconditioner raise in both."""
    for c in (capi, jcapi):
        h = c.create(A=None)
        assert c.empty(h)
        with pytest.raises(Exception):
            c.apply(h, c.OP_S, np.ones(4))
        with pytest.raises(Exception):
            c.setup(h)
        c.destroy(h)
        with pytest.raises(Exception):
            c.get_nnz(h)
