"""The rest of the preconditioner's surface and the GMRES drivers, on the CPU.

The port's adjoint solve, runtime rank, null-space filters, products M x and
M^H x, ``ir_apply(r=)`` and GMRES drivers against the JAX package and the
host ``HIF``.  Factors come from the JAX package's ``HIF`` and are carried
across with ``save_prec`` -> ``prec_from_arrays``, so every package applies
the same preconditioner.  f64 results must agree within 1e-10 relative to
max|X| (``tests/test_device.py``'s tolerance); f32 results within 1e-4 of
the host f64 solve.  The one exception to "the JAX package is the oracle"
is ``nsp_tran`` on the batched adjoint solve, which the JAX package skips:
there the port is held to the host's single-vector semantics.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hifir_tpu.alg.prec import DevicePrec as JDevicePrec
from hifir_tpu.api import HIF as JHIF
from hifir_tpu.ds.csr import csr_from_dense
from hifir_tpu.models import (convdiff2d, poisson2d, random_sparse,
                              saddle_point_stokes)
from hifir_tpu.nsp import NspFilter as JNspFilter
from hifir_tpu.ops import spmv as jspmv
from hifir_tpu.ops.pallas_spmv import bsr_from_csr as jbsr_from_csr
from hifir_tpu.options import Options
from hifir_tpu.solvers.gmres import (fgmres_hifir_device, gmres_hif_device,
                                     gmres_mrhs_device, ir_apply_device)
from hifir_tpu.utils.serialize import load_prec as jload_prec

import hifir_tpu_torch as ht
from hifir_tpu_torch.alg.prec import (DevicePrec, prec_prod_mrhs,
                                      prec_prod_tran_mrhs)
from hifir_tpu_torch.models.problems import convdiff2d as tconvdiff2d
from hifir_tpu_torch.ops import spmv
from hifir_tpu_torch.ops.bsr_spmv import bsr_from_csr
from hifir_tpu_torch.ops.spmv import sliced_ell_from_csr
from hifir_tpu_torch.ops.trsv import TrsvSchedule

from test_torch_ops import _with_empty_rows
from test_torch_prec import _carry, _m0_payload, _port, _rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "hifir_tpu_torch", "data",
                       "convdiff2d_128_prec.npz")
CPU = "cpu"
OPTS = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5, kappa_d=5,
            verbose=0, dense_thres=30)


_PROBLEMS = {"convdiff16": lambda: convdiff2d(16),
             "stokes8": lambda: saddle_point_stokes(8)}


@pytest.fixture(scope="module", params=sorted(_PROBLEMS))
def factored(request, tmp_path_factory):
    A = _PROBLEMS[request.param]()
    M = JHIF().factorize(A, Options(**OPTS))
    precs = _carry(M, tmp_path_factory.mktemp(request.param))
    B = np.random.default_rng(1).standard_normal((A.nrows, 5))
    return A, M, precs, B


# ---------------------------------------------------------------------------
# copies


def test_csr_transpose_equal_reference():
    A = random_sparse(40, 5, seed=4, ncols=27)
    T, J = _port(A).transpose(), A.transpose()
    assert T.shape == J.shape == (27, 40)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(T, f), getattr(J, f))


def test_convdiff2d_copy_equal_reference():
    A, J = tconvdiff2d(9, 7), convdiff2d(9, 7)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(A, f), getattr(J, f))


# ---------------------------------------------------------------------------
# the adjoint solve


@pytest.mark.parametrize("dense_inv", [0, 16, 32, "auto"])
def test_solve_tran_f64_matches_jax_and_host(factored, dense_inv):
    A, M, precs, B = factored
    dp = DevicePrec.from_host(precs, dense_inv=dense_inv, device=CPU)
    dp.pack_transpose(precs)
    # each level's adjoint factors take the forward factors' form
    for lvl, top in zip(dp.levels, dp.tran):
        assert type(top.LT) is type(lvl.L) and type(top.UT) is type(lvl.U)
    X = dp.solve_mrhs(B, trans=True)
    jdp = JDevicePrec.from_host(M.precs, dense_inv=dense_inv)
    jdp.pack_transpose(M.precs, dense_inv=dense_inv)
    assert _rel(X, jdp.solve_mrhs(jnp.asarray(B), trans=True)) <= 1e-10
    assert _rel(X, M.solve_mrhs(B, trans=True)) <= 1e-10
    x = dp.solve(B[:, 0], trans=True)
    assert x.shape == (A.nrows,)
    assert _rel(x, M.solve(B[:, 0], trans=True)) <= 1e-10


@pytest.mark.parametrize("dense_inv", [0, "auto"])
def test_solve_tran_f32_within_bench_gate(factored, dense_inv):
    A, M, precs, B = factored
    dp = DevicePrec.from_host(precs, dtype=np.float32, dense_inv=dense_inv,
                              device=CPU)
    dp.pack_transpose(precs)
    X = dp.solve_mrhs(B, trans=True)
    assert X.dtype == torch.float32
    assert _rel(X, M.solve_mrhs(B, trans=True)) <= 1e-4


@pytest.mark.parametrize("dense_inv", [0, "auto"])
def test_adjoint_identity(factored, dense_inv):
    """<Y, M^{-1} X> = <M^{-H} Y, X> for every column pair, with no other
    package involved."""
    A, M, precs, B = factored
    dp = DevicePrec.from_host(precs, dense_inv=dense_inv, device=CPU)
    dp.pack_transpose(precs)
    Y = torch.from_numpy(np.random.default_rng(9).standard_normal(B.shape))
    X = torch.from_numpy(B)
    MX = dp.solve_mrhs(X)
    lhs = Y.T @ MX
    rhs = dp.solve_mrhs(Y, trans=True).T @ X
    scale = (torch.linalg.vector_norm(Y, dim=0)[:, None]
             * torch.linalg.vector_norm(MX, dim=0)[None, :])
    assert bool(((lhs - rhs).abs() <= 1e-10 * scale).all())


def test_solve_tran_needs_pack_transpose(factored):
    A, M, precs, B = factored
    dp = DevicePrec.from_host(precs, device=CPU)
    with pytest.raises(RuntimeError, match="pack_transpose"):
        dp.solve_mrhs(B, trans=True)
    with pytest.raises(RuntimeError, match="pack_prod"):
        dp.mmultiply(B[:, 0])
    with pytest.raises(RuntimeError, match="pack_prod_tran"):
        dp.mmultiply(B[:, 0], trans=True)


# ---------------------------------------------------------------------------
# products


@pytest.mark.parametrize("dense_inv", [0, "auto"])
def test_mmultiply_matches_jax_and_host(factored, dense_inv):
    A, M, precs, B = factored
    dp = DevicePrec.from_host(precs, dense_inv=dense_inv, device=CPU)
    dp.pack_prod(precs)
    dp.pack_prod_tran(precs)          # packs the adjoint operands too
    # in the forward factors' form, whatever the pack's dense_inv
    for lvl, top in zip(dp.levels, dp.tran):
        assert type(top.LT) is type(lvl.L) and type(top.UT) is type(lvl.U)
    jdp = JDevicePrec.from_host(M.precs)
    jdp.pack_prod(M.precs)
    jdp.pack_prod_tran(M.precs)
    x = B[:, 0]
    for trans in (False, True):
        y = dp.mmultiply(x, trans=trans)
        assert y.shape == (A.nrows,)
        assert _rel(y, jdp.mmultiply(jnp.asarray(x), trans=trans)) <= 1e-10
        assert _rel(y, M.mmultiply(x, trans=trans)) <= 1e-10
    # the module functions on a block, column by column against the host
    Y = prec_prod_mrhs(dp.levels, dp.prod, dp.tail, torch.from_numpy(B))
    YT = prec_prod_tran_mrhs(dp.levels, dp.tran, dp.prod_tran, dp.tail,
                             torch.from_numpy(B))
    for k in range(B.shape[1]):
        assert _rel(Y[:, k], M.mmultiply(B[:, k])) <= 1e-10
        assert _rel(YT[:, k], M.mmultiply(B[:, k], trans=True)) <= 1e-10


def test_mmultiply_inverts_the_solve(factored):
    """M (M^{-1} B) = B and M^H (M^{-H} B) = B where the tail has full
    rank."""
    A, M, precs, B = factored
    dp = DevicePrec.from_host(precs, device=CPU)
    if dp.tail is not None and dp.tail.rank < dp.tail.Q.shape[0]:
        pytest.skip("rank-deficient tail: M M^{-1} is a projector")
    dp.pack_prod(precs)
    dp.pack_prod_tran(precs)
    Bt = torch.from_numpy(B)
    Y = prec_prod_mrhs(dp.levels, dp.prod, dp.tail, dp.solve_mrhs(Bt))
    YT = prec_prod_tran_mrhs(dp.levels, dp.tran, dp.prod_tran, dp.tail,
                             dp.solve_mrhs(Bt, trans=True))
    assert _rel(Y, B) <= 1e-9 and _rel(YT, B) <= 1e-9


# ---------------------------------------------------------------------------
# runtime rank and null-space filters on a singular system


@pytest.fixture(scope="module")
def singular(tmp_path_factory):
    """The singular system of ``tests/test_device.py``'s rank and nsp
    test: a centered SPD matrix, whose null space is the constant vector."""
    rng = np.random.default_rng(5)
    n = 40
    G = rng.standard_normal((n, n))
    D = G @ G.T
    D -= np.outer(D.sum(1), np.ones(n)) / n
    D -= np.outer(np.ones(n), D.sum(0)) / n
    A = csr_from_dense(D, tol=1e-14)
    b = rng.standard_normal(n)
    b -= b.mean()
    M = JHIF().factorize(A, Options(verbose=0, dense_thres=50))
    precs = _carry(M, tmp_path_factory.mktemp("singular"))
    dp = DevicePrec.from_host(precs, device=CPU)
    dp.pack_transpose(precs)
    jdp = M.to_device(dtype=jnp.float64)
    jdp.pack_transpose(M.precs, dtype=jnp.float64)
    Bb = np.stack([b, 2 * b, rng.standard_normal(n)], axis=1)
    return M, dp, jdp, b, Bb


@pytest.mark.parametrize("trans", [False, True])
def test_rank_override_equal_to_pack_rank(singular, trans):
    M, dp, jdp, b, Bb = singular
    assert dp.tail.rank >= 2
    x = dp.solve(b, trans=trans)
    np.testing.assert_allclose(dp.solve(b, trans=trans, r=dp.tail.rank), x,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("form", ["single", "mrhs"])
@pytest.mark.parametrize("trans", [False, True])
def test_rank_override_matches_jax_and_host(singular, trans, form):
    M, dp, jdp, b, Bb = singular
    rank = dp.tail.rank
    for r in (rank - 1, max(rank - 3, 1)):
        if form == "single":
            x = dp.solve(b, trans=trans, r=r)
            xj = jdp.solve(jnp.asarray(b), trans=trans, r=r)
            xh = M.solve(b, trans=trans, r=r)
        else:
            x = dp.solve_mrhs(Bb, trans=trans, r=r)
            xj = jdp.solve_mrhs(jnp.asarray(Bb), trans=trans, r=r)
            xh = M.solve_mrhs(Bb, r=r, trans=trans)
        assert _rel(x, xj) <= 1e-10
        assert _rel(x, xh) <= 1e-10


@pytest.fixture(scope="module", params=["qrcp", "syeig", "lup"])
def dense_level(request, tmp_path_factory):
    pay, D = _m0_payload(request.param)
    path = tmp_path_factory.mktemp(request.param) / "m0.npz"
    np.savez(path, **pay)
    M = ht.load_prec(str(path))
    dp = M.to_device(device=CPU)
    dp.pack_transpose(M.precs)
    jdp = jload_prec(str(path)).to_device()
    jdp.pack_transpose(jload_prec(str(path)).precs)
    return request.param, D, M, dp, jdp


@pytest.mark.parametrize("trans", [False, True])
def test_tail_rank_override_by_kind(dense_level, trans):
    """QRCP and SYEIG truncate at the runtime rank, LUP ignores it, against
    the JAX package's masked ``tail_solve_rank``."""
    kind, D, M, dp, jdp = dense_level
    B = np.random.default_rng(5).standard_normal((8, 3))
    X = dp.solve_mrhs(B, trans=trans, r=5)
    assert _rel(X, jdp.solve_mrhs(jnp.asarray(B), trans=trans, r=5)) <= 1e-10
    if kind == "lup":
        assert _rel(X, np.linalg.solve(D.T if trans else D, B)) <= 1e-10
    else:
        assert _rel(X, dp.solve_mrhs(B, trans=trans)) > 1e-3


@pytest.mark.parametrize("trans", [False, True])
def test_m0_level_adjoint_and_products(dense_level, trans):
    """``pack_transpose`` packs an empty schedule for an m == 0 level (the
    JAX package packs a 2048^2 identity); results against exact dense
    solves and products."""
    kind, D, M, dp, jdp = dense_level
    top = dp.tran[0]
    assert isinstance(top.LT, TrsvSchedule) and top.LT.nchunks == 0
    assert isinstance(top.UT, TrsvSchedule) and top.UT.nchunks == 0
    B = np.random.default_rng(6).standard_normal((8, 3))
    Dt = D.T if trans else D
    X = dp.solve_mrhs(B, trans=trans)
    assert _rel(X, np.linalg.solve(Dt, B)) <= 1e-10
    assert _rel(X, jdp.solve_mrhs(jnp.asarray(B), trans=trans)) <= 1e-10
    dp.pack_prod(M.precs)
    dp.pack_prod_tran(M.precs)
    assert _rel(dp.mmultiply(B[:, 0], trans=trans), Dt @ B[:, 0]) <= 1e-10


@pytest.mark.parametrize("trans", [False, True])
def test_nsp_single_matches_jax_and_host(singular, trans):
    M, dp, jdp, b, Bb = singular
    name = "nsp_tran" if trans else "nsp"
    for obj, f in ((M, JNspFilter()), (jdp, JNspFilter()),
                   (dp, ht.NspFilter())):
        setattr(obj, name, f)
    try:
        x = dp.solve(b, trans=trans)
        xh = M.solve(b, trans=trans)
        xj = jdp.solve(jnp.asarray(b), trans=trans)
    finally:
        for obj in (M, jdp, dp):
            setattr(obj, name, None)
    assert abs(float(x.mean())) < 1e-12
    assert _rel(x, xh) <= 1e-10 and _rel(x, xj) <= 1e-10


@pytest.mark.parametrize("trans", [False, True])
def test_nsp_mrhs(singular, trans):
    """Every column is filtered.  The forward block matches the JAX
    package's; the adjoint block applies ``nsp_tran``, which the JAX package
    skips there, so it is held to the host's solve column by column."""
    M, dp, jdp, b, Bb = singular
    name = "nsp_tran" if trans else "nsp"
    setattr(dp, name, ht.NspFilter())
    setattr(M, name, JNspFilter())
    try:
        X = dp.solve_mrhs(Bb, trans=trans)
        Xh = np.stack([M.solve(Bb[:, k], trans=trans)
                       for k in range(Bb.shape[1])], axis=1)
        if not trans:
            jdp.nsp = JNspFilter()
            assert _rel(X, jdp.solve_mrhs(jnp.asarray(Bb))) <= 1e-10
    finally:
        setattr(dp, name, None)
        setattr(M, name, None)
        jdp.nsp = None
    assert float(X.mean(dim=0).abs().max()) < 1e-12 * float(X.abs().max())
    assert _rel(X, Xh) <= 1e-10


def test_nsp_user_func_and_range(singular):
    """A callback takes and returns the tensor; the constant mode touches
    only its row range."""
    M, dp, jdp, b, Bb = singular
    seen = []

    def negate(x):
        seen.append(type(x))
        return -x

    x0 = dp.solve(b)
    dp.nsp = ht.NspFilter(user_func=negate)
    try:
        x = dp.solve(b)
    finally:
        dp.nsp = None
    assert seen == [torch.Tensor] and torch.equal(x, -x0)
    y = ht.NspFilter(start=4, end=20).filter(x0)
    assert torch.equal(y[:4], x0[:4]) and torch.equal(y[20:], x0[20:])
    assert abs(float(y[4:20].mean())) < 1e-12


# ---------------------------------------------------------------------------
# refinement and GMRES against the JAX drivers


def _operators(A, op):
    if op == "bsr":
        return bsr_from_csr(_port(A), bs=64, device=CPU), jbsr_from_csr(A,
                                                                      bs=64)
    return (sliced_ell_from_csr(_port(A), device=CPU),
            jspmv.sliced_ell_from_csr(A))


@pytest.fixture(scope="module")
def convdiff12(tmp_path_factory):
    A = convdiff2d(12)
    M = JHIF().factorize(A, Options(**OPTS))
    dp = DevicePrec.from_host(_carry(M, tmp_path_factory.mktemp("cd12")),
                              device=CPU)
    return A, M, dp, JDevicePrec.from_host(M.precs)


@pytest.mark.parametrize("op", ["bsr", "sliced_ell"])
def test_ir_apply_rank_matches_jax(convdiff12, op):
    A, M, dp, jdp = convdiff12
    At, Aj = _operators(A, op)
    r = dp.tail.rank - 2
    b = np.random.default_rng(3).standard_normal(A.nrows)
    x = ht.ir_apply(At, dp, b, nirs=3, r=r)
    xj = ir_apply_device(Aj, jdp.levels, jdp.tail, jnp.asarray(b), 3,
                         r=jnp.int32(r))
    assert _rel(x, xj) <= 1e-10
    assert _rel(x, ht.ir_apply(At, dp, b, nirs=3)) > 1e-8   # r took effect


@pytest.mark.parametrize("op", ["bsr", "sliced_ell"])
def test_gmres_hif_matches_jax(convdiff12, op):
    A, M, dp, jdp = convdiff12
    At, Aj = _operators(A, op)
    b = np.random.default_rng(4).standard_normal(A.nrows)
    x, flag, it = ht.gmres_hif(At, dp, b, restart=4, rtol=1e-10)
    xj, flagj, itj = gmres_hif_device(Aj, jdp, jnp.asarray(b), restart=4,
                                      rtol=1e-10)
    assert (flag, it) == (flagj, itj) and flag == 0 and it > 4
    assert _rel(x, xj) <= 1e-8
    assert np.linalg.norm(b - A.matvec(x.numpy())) <= 1e-9 * np.linalg.norm(b)


def test_fgmres_hifir_rank_matches_jax(tmp_path):
    A = poisson2d(12)
    M = JHIF().factorize(A, Options(verbose=0, dense_thres=30))
    dp = DevicePrec.from_host(_carry(M, tmp_path), device=CPU)
    jdp = M.to_device(dtype=jnp.float64)
    At, Aj = _operators(A, "sliced_ell")
    b = np.random.default_rng(0).standard_normal(A.nrows)
    x, flag, it = ht.fgmres_hifir(At, dp, b, restart=3, rtol=1e-10,
                                  rank=dp.tail.rank)
    xj, flagj, itj = fgmres_hifir_device(Aj, jdp, jnp.asarray(b), restart=3,
                                         rtol=1e-10, rank=jdp.tail.rank)
    assert (flag, it) == (flagj, itj) and flag == 0
    assert _rel(x, xj) <= 1e-8


@pytest.mark.parametrize("op", ["bsr", "sliced_ell"])
def test_gmres_mrhs_matches_jax(convdiff12, op):
    """Batched GMRES with a zero column (which stays exactly zero)."""
    A, M, dp, jdp = convdiff12
    At, Aj = _operators(A, op)
    B = np.random.default_rng(0).standard_normal((A.nrows, 6))
    B[:, 3] = 0.0
    X, flag, cycles = ht.gmres_mrhs(At, dp, B, restart=3, rtol=1e-8)
    Xj, flagj, cyclesj = gmres_mrhs_device(Aj, jdp, jnp.asarray(B),
                                           restart=3, rtol=1e-8)
    assert (flag, cycles) == (flagj, cyclesj) and flag == 0 and cycles > 1
    assert _rel(X, Xj) <= 1e-8
    assert not X[:, 3].any()
    for k in (0, 1, 2, 4, 5):
        assert (np.linalg.norm(B[:, k] - A.matvec(X[:, k].numpy()))
                <= 1e-8 * np.linalg.norm(B[:, k]))


def test_gmres_zero_rhs(convdiff12):
    """A zero right-hand side returns zeros at once, as in the JAX package."""
    A, M, dp, jdp = convdiff12
    At = sliced_ell_from_csr(_port(A), device=CPU)
    for drive in (ht.gmres_hif, ht.fgmres_hifir):
        x, flag, it = drive(At, dp, np.zeros(A.nrows))
        assert (flag, it) == (0, 0) and not x.any()


# ---------------------------------------------------------------------------
# the nonsymmetric fixture


def test_convdiff_fixture_loads_like_reference():
    """``hifir_tpu_torch/data/convdiff2d_128_prec.npz`` was written by the
    JAX package::

        python -c "from hifir_tpu.api import HIF; \\
        from hifir_tpu.models import convdiff2d; \\
        from hifir_tpu.options import Options; \\
        from hifir_tpu.utils.serialize import save_prec; \\
        save_prec('hifir_tpu_torch/data/convdiff2d_128_prec.npz', \\
        HIF().factorize(convdiff2d(128), Options(tau_L=1e-2, tau_U=1e-2, \\
        alpha_L=3, alpha_U=3, kappa=3, kappa_d=3, dense_thres=600, \\
        verbose=0)))"

    Its levels are not symmetric (unlike ``benchdata/frozen_prec.npz``), so
    an adjoint solve that used the forward operands would fail on it."""
    M = ht.load_prec(FIXTURE)
    J = jload_prec(FIXTURE)
    assert [(p.m, p.n) for p in M.precs] == [(13883, 16384), (2298, 2501)]
    assert M.nnz() == J.nnz()
    for p, jp in zip(M.precs, J.precs):
        for f in ("d", "s", "t", "p", "p_inv", "q", "q_inv"):
            np.testing.assert_array_equal(getattr(p, f), getattr(jp, f))
        for f in ("L_B", "U_B", "E", "F"):
            a, b = getattr(p, f), getattr(jp, f)
            assert a.shape == b.shape
            for g in ("indptr", "indices", "data"):
                np.testing.assert_array_equal(getattr(a, g), getattr(b, g))
    p0 = M.precs[0]
    Et = p0.E.to_scipy()
    assert abs(Et - p0.F.to_scipy().T).max() > 1e-3    # E != F^T
    ds = M.precs[-1].dense_solver
    assert (ds.kind, ds.rank, ds.n) == ("qrcp", 203, 203)


def test_convdiff_fixture_solve_tran_matches_jax():
    """One f64 adjoint solve of 4 RHS through the level scan
    (dense_inv=0)."""
    B = np.random.default_rng(2).standard_normal((16384, 4))
    M = ht.load_prec(FIXTURE)
    dp = M.to_device(device=CPU, dense_inv=0)
    dp.pack_transpose(M.precs)
    X = dp.solve_mrhs(B, trans=True)
    J = jload_prec(FIXTURE)
    jdp = JDevicePrec.from_host(J.precs, dense_inv=0)
    jdp.pack_transpose(J.precs, dense_inv=0)
    assert _rel(X, jdp.solve_mrhs(jnp.asarray(B), trans=True)) <= 1e-10
    assert _rel(X, dp.solve_mrhs(B)) > 1e-3     # M^{-H} differs from M^{-1}


# ---------------------------------------------------------------------------
# K1's sign


@pytest.mark.parametrize("in_place", [True, False])
@pytest.mark.parametrize("nrhs", [1, 5])
@pytest.mark.parametrize("sliced", [True, False])
def test_k1_plus_plain_matches_reference(in_place, nrhs, sliced):
    """out = C + A X (``sign=1``) against the JAX package's
    C + ell_matvec_mrhs(A, X)."""
    A = _with_empty_rows(random_sparse(120, 9, seed=2, ncols=77))
    rng = np.random.default_rng(7)
    X = rng.standard_normal((77, nrhs))
    C = rng.standard_normal((120, nrhs))
    pack, jpack = ((spmv.sliced_ell_from_csr, jspmv.sliced_ell_from_csr)
                   if sliced else (spmv.ell_from_csr, jspmv.ell_from_csr))
    Ct = torch.from_numpy(C.copy())
    out = Ct if in_place else torch.empty_like(Ct)
    Y = spmv.sliced_ell_sub_mrhs(pack(_port(A), device=CPU),
                                 torch.from_numpy(X), Ct, out=out, sign=1)
    assert Y is out
    Yj = C + np.asarray(jspmv.ell_matvec_mrhs(jpack(A), jnp.asarray(X)))
    np.testing.assert_allclose(Y.numpy(), Yj, rtol=1e-12,
                               atol=1e-12 * np.abs(Yj).max())


def test_k1_sign_checked_and_cpu_refused():
    """A sign other than -1 or +1 is refused; the launcher refuses CPU
    tensors for ``sign=1`` in every form, before any build or launch."""
    A = poisson2d(16)
    s = spmv.sliced_ell_from_csr(_port(A), device=CPU)
    e = spmv.ell_from_csr(_port(A), device=CPU)
    X = torch.zeros((A.nrows, 2), dtype=torch.float64)
    C = torch.zeros((A.nrows, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="sign"):
        spmv.sliced_ell_sub_mrhs(s, X, C, sign=0)
    with pytest.raises(ValueError, match="sign"):
        spmv.sell_spmv_cuda(s, X, C, sign=2)
    for launch in (lambda: spmv.sell_spmv_cuda(s, X, C, C, sign=1),
                   lambda: spmv.sell_spmv_cuda(s, X, C, torch.empty_like(C),
                                               sign=1),
                   lambda: spmv.sell_spmv_cuda(e, X, C, sign=1),
                   lambda: spmv.sell_spmv_cuda(s, X[:, :1].contiguous(),
                                               C[:, :1].contiguous(),
                                               sign=1)):
        with pytest.raises(ValueError, match="CUDA"):
            launch()
    assert (spmv.sell_spmv_cuda.launches,
            spmv.sell_spmv_cuda.plus_launches) == (0, 0)


def test_surface_defaults_to_cuda(factored):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    A, M, precs, B = factored
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sliced_ell_from_csr(_port(A))
    dp = DevicePrec.from_host(precs, device=CPU)
    dp.pack_transpose(precs)
    assert all(t.ET.flat_values.device.type == "cpu" for t in dp.tran)
    x, flag, it = ht.gmres_hif(sliced_ell_from_csr(_port(A), device=CPU), dp,
                               B[:, 0])
    assert x.device.type == "cpu" and flag == 0
