"""K7, K1 and K2 (``csrc/kernels.cu``) against their plain versions on the
card, at the main path's shapes.

- K7 (BSR SpMV) on poisson2d(128) as BSR (bs = 128) at 128, 8 and 1
  right-hand sides, so that each of its three paths (DMMA, 3xTF32,
  streaming) is held; each forced path where the choice turns (1, 2 and 4
  right-hand sides).
- K1 (sliced-ELL SpMV with the fused ``C - A X`` epilogue) on the frozen
  fixture's level-0 E and F in place at 128, 8 and 1 and as the product at
  128; the heaviest Off_b of each blocked inverse in the form its call site
  uses; ``C + A X`` (sign +1, the products') on the nonsymmetric fixture's
  level-0 U_B; K1 on a uniform ELL.
- K2 (level-scheduled triangular solve) on both levels' L and U schedules
  of the ``dense_inv=0`` pack at 128 and 1.
- The complex rows: K1 on the complex fixture's level-0 E in place and on
  its U_B with sign +1, K2 on its level-0 L, in c64 and c128.

Each in f32 and f64 (c64 and c128), within 1e-5 / 1e-12 of the plain
version's largest entry.  The inputs are drawn from ``default_rng(0)``
(the complex rows' from ``default_rng(2)``) in one fixed order
(``card_common.kernel_cases``).  Every test needs an NVIDIA GPU and skips
without one; on the card: ``python3 -m pytest tests/test_torch_kernels_card.py
-q --noconftest``.
"""

import functools

import numpy as np
import pytest
import torch

import hifir_tpu_torch as ht
from card_common import (CONVDIFF, CONVDIFF_C, CPLX, FIXTURE, OFF_ROWS,
                         case_id, complex_cases, complex_draws, kernel_cases,
                         kernel_draws, rel_diff, skip_without_card)
from hifir_tpu_torch.models.problems import poisson2d
from hifir_tpu_torch.ops import bsr_spmv, spmv, trsv

pytestmark = pytest.mark.card


@pytest.fixture(scope="module", autouse=True)
def card():
    skip_without_card()


TOL = {"float32": 1e-5, "float64": 1e-12, "complex64": 1e-5,
       "complex128": 1e-12}


def cases(prefix, table):
    return [c for c in table if c[1].startswith(prefix)]


@pytest.fixture(scope="module")
def fixtures():
    return ht.load_prec(FIXTURE), ht.load_prec(CONVDIFF)


@pytest.fixture(scope="module")
def draws(fixtures):
    return kernel_draws(*fixtures)[0]


@pytest.fixture(scope="module")
def operands(fixtures):
    """The card operands of the real rows, a dtype at a time."""
    M, Mc = fixtures
    assert len(M.precs) == 2

    @functools.cache
    def of(dname):
        npdt = np.dtype(dname)
        host = M.precs[0]
        ops = dict(Ab=bsr_spmv.bsr_from_csr(poisson2d(128), bs=128,
                                             dtype=npdt),
                   dp=M.to_device(dtype=npdt, dense_inv=0),
                   Uplus=spmv.sliced_ell_from_csr(Mc.precs[0].U_B,
                                                  dtype=npdt),
                   ell_E=spmv.ell_from_csr(host.E, dtype=npdt))
        for nm, (f, lower, b) in OFF_ROWS.items():
            bd = trsv.build_trsv_block_dense(getattr(host, f), lower=lower,
                                             W=2048, dtype=npdt)
            short = bd.n - bd.starts[b] < bd.W
            ops[nm] = (bd.offs[b], "in-place" if short else "out-of-place")
        return ops

    return of


def tensors(arrays, dt):
    return [torch.as_tensor(a, dtype=dt, device="cuda") for a in arrays]


def k1_check(A, X, C, form, sign, tol):
    """K1 on operator ``A`` in ``form`` (as its call site runs it) against
    the plain version."""
    assert X.shape[0] == A.ncols and (C is None or C.shape[0] == A.nrows)
    if form == "in-place":
        Y = C.clone()
        spmv.sliced_ell_sub_mrhs(A, X, Y, out=Y, sign=sign)
    else:
        Y = spmv.sliced_ell_sub_mrhs(A, X, C, sign=sign)
    Yp = spmv.sliced_ell_sub_mrhs_plain(A, X, C, sign=sign)
    torch.cuda.synchronize()
    rel = rel_diff(Y, Yp)
    assert rel <= tol, f"K1 rel err {rel:.3e} > {tol}"


def k2_check(S, B, tol):
    assert B.shape[0] == S.n
    Xk = trsv.trsv_apply_mrhs(S, B)
    Xp = trsv.trsv_apply_plain(S, B)
    torch.cuda.synchronize()
    rel = rel_diff(Xk, Xp)
    assert rel <= tol, f"K2 rel err {rel:.3e} > {tol}"


@pytest.mark.parametrize("case", [c for c in kernel_cases() if c[1] == "K7"],
                         ids=case_id)
def test_k7_equals_plain(case, draws, operands):
    dname, _, nrhs = case
    Ab = operands(dname)["Ab"]
    (X,) = tensors(draws[case], getattr(torch, dname))
    assert X.shape == (Ab.nbr * Ab.bs, nrhs)
    Y = bsr_spmv.bsr_matvec_mrhs(Ab, X)
    Yp = bsr_spmv.bsr_matvec_mrhs_plain(Ab, X)
    torch.cuda.synchronize()
    rel = rel_diff(Y, Yp)
    assert rel <= TOL[dname], (
        f"K7 path {bsr_spmv.bsr_path(X.dtype, nrhs)}: {rel:.3e}")


@pytest.mark.parametrize("case", cases("K7 paths", kernel_cases()),
                         ids=case_id)
def test_k7_each_path_equals_plain(case, draws, operands):
    """Each of K7's paths where the choice turns, forced."""
    dname, _, nrhs = case
    Ab = operands(dname)["Ab"]
    (X,) = tensors(draws[case], getattr(torch, dname))
    Yp = bsr_spmv.bsr_matvec_mrhs_plain(Ab, X)
    tensor = "tf32x3" if dname == "float32" else "dmma"
    for p in ["stream", tensor] if nrhs <= 2 else [tensor]:
        Y = bsr_spmv.bsr_spmv_cuda(Ab, X, path=p)
        torch.cuda.synchronize()
        rel = rel_diff(Y, Yp)
        assert rel <= TOL[dname], f"K7 nrhs={nrhs} path={p}: {rel:.3e}"


@pytest.mark.parametrize("case", cases("K1", kernel_cases()), ids=case_id)
def test_k1_equals_plain(case, draws, operands):
    dname, row, _ = case
    ops, dt = operands(dname), getattr(torch, dname)
    arrays = tensors(draws[case], dt)
    X, C = arrays[0], (arrays[1] if len(arrays) > 1 else None)
    if row == "K1 ell E":
        El = ops["ell_E"]
        Y = spmv.ell_matvec_mrhs(El, X)
        Yp = spmv.ell_matvec_mrhs_plain(El, X)
        torch.cuda.synchronize()
        assert rel_diff(Y, Yp) <= TOL[dname]
        return
    lvl = ops["dp"].levels[0]
    if row == "K1 Uplus":
        k1_check(ops["Uplus"], X, C, "in-place", 1, TOL[dname])
    elif row in ("K1 Loff", "K1 Uoff"):
        A, form = ops[row.split()[1]]
        k1_check(A, X, C, form, -1, TOL[dname])
    else:
        A = lvl.E if row.startswith("K1 E") else lvl.F
        k1_check(A, X, C, row.split()[2], -1, TOL[dname])


@pytest.mark.parametrize("case", cases("K2", kernel_cases()), ids=case_id)
def test_k2_equals_plain(case, draws, operands):
    dname, row, _ = case
    lv = operands(dname)["dp"].levels[int(row[-1])]
    (B,) = tensors(draws[case], getattr(torch, dname))
    k2_check(lv.L if row[3] == "L" else lv.U, B, TOL[dname])


@pytest.fixture(scope="module")
def complex_rows():
    """The complex fixture, its ``dense_inv=0`` packs and the rows' inputs."""
    Mz = ht.load_prec(CONVDIFF_C)
    _, rows, _ = complex_draws(Mz)
    packs = {dt: Mz.to_device(dtype=np.dtype(dt), dense_inv=0)
             for dt in CPLX}
    return Mz, packs, rows


@pytest.mark.parametrize("case", complex_cases(), ids=case_id)
def test_complex_rows_equal_plain(case, complex_rows):
    dname, row, _ = case
    Mz, packs, rows = complex_rows
    dt = getattr(torch, dname)
    arrays = tensors(rows[case], dt)
    lvl = packs[dname].levels[0]
    if row == "K1 E in-place":
        k1_check(lvl.E, arrays[0], arrays[1], "in-place", -1, TOL[dname])
    elif row == "K1 Uplus":
        Uell = spmv.sliced_ell_from_csr(Mz.precs[0].U_B,
                                        dtype=np.dtype(dname))
        k1_check(Uell, arrays[0], arrays[1], "in-place", 1, TOL[dname])
    else:
        k2_check(lvl.L, arrays[0], TOL[dname])

