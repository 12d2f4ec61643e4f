"""complex128 and complex64 through the port's whole surface, on the CPU.

The JAX package is the oracle, run on the CPU with 64-bit types (as its own
tests run): the plain K1 and K2 against ``ell_matvec_mrhs`` and
``trsv_apply_mrhs`` on complex operands, and the whole surface (forward and
adjoint solves, one vector and a block, the runtime rank, the null-space
filter, the products both ways, ``ir_apply``, the GMRES drivers) against
``DevicePrec(dtype=None)`` and the host ``HIF`` on three complex operators:
a complex-shifted convection-diffusion operator (general LDU levels), a
Hermitian one and a complex-symmetric one.  c128 results agree within 1e-10
relative to max|X|, c64 results within 1e-4 of the c128 JAX result.  Every
comparison measures the magnitude of the complex difference (``_rel``), so
a lost imaginary part fails it.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from hifir_tpu.alg.prec import DevicePrec as JDevicePrec
from hifir_tpu.api import HIF as JHIF
from hifir_tpu.ds import CSR as JCSR
from hifir_tpu.models import (convdiff2d, poisson2d, random_sparse,
                              random_strict_triangular)
from hifir_tpu.nsp import NspFilter as JNspFilter
from hifir_tpu.ops import spmv as jspmv
from hifir_tpu.ops import trsv as jtrsv
from hifir_tpu.options import Options
from hifir_tpu.solvers.gmres import gmres_mrhs_device, ir_apply_device
from hifir_tpu.utils.serialize import load_prec as jload_prec

import hifir_tpu_torch as ht
from hifir_tpu_torch import device
from hifir_tpu_torch.alg.prec import (DevicePrec, prec_prod_mrhs,
                                      prec_prod_tran_mrhs)
from hifir_tpu_torch.kernels import build
from hifir_tpu_torch.models.problems import convdiff2d as tconvdiff2d
from hifir_tpu_torch.models.problems import shift_diagonal
from hifir_tpu_torch.ops import bsr_spmv, spmv, trsv

from test_torch_ops import _eq, _eq_sched, _eq_sliced, _with_empty_rows
from test_torch_prec import _carry, _port, _rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "hifir_tpu_torch", "data",
                       "convdiff2d_128_c_prec.npz")
CPU = "cpu"
OPTS = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5, kappa_d=5,
            verbose=0, dense_thres=30)


def _crandn(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _shifted(A) -> JCSR:
    """The JAX package's CSR of ``A + (-0.1 + 0.1i) diag(|a_ii|)``."""
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


# ---------------------------------------------------------------------------
# dtype plumbing


def test_torch_dtype_maps_complex():
    for npdt, tdt, real in ((np.complex64, torch.complex64, torch.float32),
                            (np.complex128, torch.complex128, torch.float64),
                            (np.float32, torch.float32, torch.float32)):
        assert device.torch_dtype(npdt) == tdt
        assert device.numpy_dtype(tdt) == np.dtype(npdt)
        assert device.real_dtype(npdt) == device.real_dtype(tdt) == real
    with pytest.raises(TypeError, match="complex64, complex128"):
        device.torch_dtype(np.float16)


def test_rel_measures_the_complex_difference():
    """The tests' ``_rel`` compares complex values as complex: a casting
    version saw no difference between x and x + 1e-3 i."""
    x = np.linspace(1.0, 2.0, 7)
    assert _rel(x + 1e-3j, x) == pytest.approx(5e-4)
    assert _rel(torch.from_numpy(1j * x), x) == pytest.approx(np.sqrt(2))
    assert _rel(torch.from_numpy(x + 1j).conj(), x - 1j) == 0


def test_kernel_fn_suffixes():
    """K1 and K2 are built for c64 and c128; K7 only for f32 and f64."""
    for name in ("sell_spmv", "trsv_solve"):
        assert build.SUFFIXES[name] == ("f32", "f64", "c64", "c128")
        assert build.dtype_suffix(name, torch.complex64) == "c64"
        assert build.dtype_suffix(name, torch.complex128) == "c128"
    assert build.SUFFIXES["bsr_spmv"] == ("f32", "f64")
    with pytest.raises(TypeError, match="float32, float64 required"):
        build.dtype_suffix("bsr_spmv", torch.complex128)
    src = build.SOURCE.read_text()
    for sfx, t in (("c64", "C64"), ("c128", "C128")):
        assert f"HIFIR_DEFINE({sfx}, {t})" in src
        assert f"HIFIR_DEFINE_BSR({sfx}" not in src


def test_kernel_fn_refuses_conj_and_neg_views():
    """A lazy conjugate (or negative) view's memory is not what it holds:
    the wrapper refuses it by name, before the device check, so that the
    refusal shows on the CPU too; a plain complex operand goes on to the
    device check."""
    A = spmv.sliced_ell_from_csr(_port(random_sparse(40, 4, seed=1,
                                                     dtype=np.complex128)),
                                 device=CPU)
    rng = np.random.default_rng(0)
    X = torch.from_numpy(_crandn(rng, (40, 3)))
    C = torch.from_numpy(_crandn(rng, (40, 3)))
    with pytest.raises(ValueError, match="operand X has the conjugate bit"):
        spmv.sell_spmv_cuda(A, X.conj(), C)
    with pytest.raises(ValueError, match="operand C has the conjugate bit"):
        spmv.sell_spmv_cuda(A, X, C.conj())
    with pytest.raises(ValueError, match="operand X has the negative bit"):
        spmv.sell_spmv_cuda(A, torch._neg_view(X), C)
    with pytest.raises(ValueError, match="CUDA"):
        spmv.sell_spmv_cuda(A, X, C)
    T = trsv.build_trsv_schedule(_port(_ctriangle(60, True, 2)), lower=True,
                                 chunk=8, device=CPU)
    B = torch.from_numpy(_crandn(rng, (60, 2)))
    with pytest.raises(ValueError, match="operand B has the conjugate bit"):
        trsv.trsv_apply_cuda(T, B.conj())
    with pytest.raises(ValueError, match="CUDA"):
        trsv.trsv_apply_cuda(T, B)
    with pytest.raises(TypeError, match="mixed dtypes"):
        spmv.sell_spmv_cuda(A, X.to(torch.complex64), C)
    assert spmv.sell_spmv_cuda.launches == trsv.trsv_apply_cuda.launches == 0


def test_k7_refuses_complex():
    """K7 is real only, as the TPU kernel: the packer, the launcher and the
    plain version refuse complex, so that the CPU and the card agree."""
    A = poisson2d(16)
    with pytest.raises(TypeError, match="real only"):
        bsr_spmv.bsr_from_csr(_port(_shifted(A)), bs=64, device=CPU)
    with pytest.raises(TypeError, match="real only"):
        bsr_spmv.bsr_from_csr(_port(A), bs=64, dtype=np.complex64,
                              device=CPU)
    b = bsr_spmv.bsr_from_csr(_port(A), bs=64, device=CPU)
    X = torch.zeros((b.nbr * b.bs, 2), dtype=torch.complex128)
    for fn in (bsr_spmv.bsr_matvec_mrhs, bsr_spmv.bsr_matvec_mrhs_plain,
               bsr_spmv.bsr_spmv_cuda):
        with pytest.raises(TypeError, match="real only"):
            fn(b, X)
    assert bsr_spmv.bsr_spmv_cuda.launches == 0


# ---------------------------------------------------------------------------
# plain K1 and K2 against the JAX functions


@pytest.mark.parametrize("in_place", [True, False])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("nrhs", [1, 5])
@pytest.mark.parametrize("sliced", [True, False])
def test_k1_plain_complex_matches_reference(in_place, sign, nrhs, sliced):
    """out = C + sign A X on a complex A with rows without entries, against
    the JAX package's C + sign ell_matvec_mrhs(A, X): c128 within 1e-13, c64
    within 1e-5 of the c128 result; the product A X too."""
    A = _with_empty_rows(random_sparse(120, 9, seed=2, ncols=77,
                                       dtype=np.complex128))
    assert np.iscomplexobj(A.data) and np.abs(A.data.imag).max() > 0.5
    rng = np.random.default_rng(7)
    X, C = _crandn(rng, (77, nrhs)), _crandn(rng, (120, nrhs))
    pack, jpack = ((spmv.sliced_ell_from_csr, jspmv.sliced_ell_from_csr)
                   if sliced else (spmv.ell_from_csr, jspmv.ell_from_csr))
    AXj = np.asarray(jspmv.ell_matvec_mrhs(jpack(A), jnp.asarray(X)))
    Yj = C + sign * AXj
    results = {}
    for npdt, tdt in ((np.complex128, torch.complex128),
                      (np.complex64, torch.complex64)):
        Ap = pack(_port(A), dtype=npdt, device=CPU)
        Ct = torch.from_numpy(C.astype(npdt))
        out = Ct if in_place else torch.empty_like(Ct)
        Y = spmv.sliced_ell_sub_mrhs(Ap, torch.from_numpy(X.astype(npdt)),
                                     Ct, out=out, sign=sign)
        assert Y is out and Y.dtype == tdt
        results[npdt] = Y
        AX = spmv.sliced_ell_sub_mrhs(Ap, torch.from_numpy(X.astype(npdt)))
        assert _rel(AX, AXj) <= (1e-13 if npdt == np.complex128 else 1e-5)
    assert _rel(results[np.complex128], Yj) <= 1e-13
    assert _rel(results[np.complex64], results[np.complex128]) <= 1e-5


def _ctriangle(n, lower, seed):
    """A random strict triangle with complex values (``random_strict_
    triangular``'s pattern and real parts, an imaginary part added) and a
    few dense rows, so that the schedule splits rows and has many levels."""
    rng = np.random.default_rng(seed)
    T = random_strict_triangular(n, lower=lower, seed=seed)
    M = sp.csr_matrix((T.data + 1j * rng.standard_normal(T.data.size),
                       T.indices, T.indptr), shape=(n, n)).tolil()
    for i in ((n // 2, n - 1) if lower else (0, n // 3)):
        js = np.arange(i) if lower else np.arange(i + 1, n)
        M[i, js] = 0.1 * _crandn(rng, js.size)
    return JCSR.from_scipy(M.tocsr())


@pytest.mark.parametrize("chunk,k_cap", [(8, None), (16, "auto")])
@pytest.mark.parametrize("lower", [True, False])
def test_k2_plain_complex_matches_reference(chunk, k_cap, lower):
    """The plain level scan on a complex schedule (several levels, split
    rows with ``k_cap``) against the JAX package's trsv_apply_mrhs and an
    exact triangular solve: c128 within 1e-12, c64 within 1e-5 of it."""
    T = _ctriangle(200, lower, 5)
    s = trsv.build_trsv_schedule(_port(T), lower=lower, chunk=chunk,
                                 k_cap=k_cap, device=CPU)
    js = jtrsv.build_trsv_schedule(T, lower=lower, chunk=chunk, k_cap=k_cap)
    _eq_sched(s, js)
    assert s.vals.dtype == torch.complex128 and s.nlevels > 4
    B = _crandn(np.random.default_rng(4), (T.nrows, 5))
    X = trsv.trsv_apply_mrhs(s, torch.from_numpy(B))
    Xj = np.asarray(jtrsv.trsv_apply_mrhs(js, jnp.asarray(B)))
    assert _rel(X, Xj) <= 1e-12
    S = T.to_scipy().toarray()
    Mt = np.eye(T.nrows) + (np.tril(S, -1) if lower else np.triu(S, 1))
    assert _rel(X, np.linalg.solve(Mt, B)) <= 1e-12
    s64 = trsv.build_trsv_schedule(_port(T), lower=lower, chunk=chunk,
                                   k_cap=k_cap, dtype=np.complex64,
                                   device=CPU)
    X64 = trsv.trsv_apply_mrhs(s64, torch.from_numpy(B.astype(np.complex64)))
    assert X64.dtype == torch.complex64 and _rel(X64, Xj) <= 1e-5


@pytest.mark.parametrize("lower", [True, False])
def test_trsv_dense_keeps_complex(lower):
    """The explicit and blocked inverses of a complex factor equal the JAX
    package's bit for bit; the dense one was built from a float64 copy,
    which dropped the imaginary part."""
    T = _ctriangle(90, lower, 8)
    d = trsv.build_trsv_dense(_port(T), lower=lower, device=CPU)
    jd = jtrsv.build_trsv_dense(T, lower=lower)
    _eq(d.inv, jd.inv)
    assert float(d.inv.imag.abs().max()) > 0.1
    bd = trsv.build_trsv_block_dense(_port(T), lower=lower, W=32, device=CPU)
    jbd = jtrsv.build_trsv_block_dense(T, lower=lower, W=32)
    for a, ja in zip(bd.invs, jbd.invs):
        _eq(a, ja)
    for o, jo in zip(bd.offs, jbd.offs):
        _eq_sliced(o, jo)
    B = _crandn(np.random.default_rng(1), (T.nrows, 3))
    for form, jform in ((d, jd), (bd, jbd)):
        X = trsv.trsv_apply_mrhs(form, torch.from_numpy(B))
        assert _rel(X, jtrsv.trsv_apply_mrhs(jform, jnp.asarray(B))) <= 1e-12


def test_plain_versions_count_their_calls():
    """The plain versions' call counters, which the card tests
    (``tests/test_torch_prec_card.py``) read to show that no operand of the
    complex parts reached one on the card."""
    A = spmv.sliced_ell_from_csr(_port(random_sparse(30, 3, seed=1)),
                                 device=CPU)
    s = trsv.build_trsv_schedule(_port(_ctriangle(40, True, 1)), lower=True,
                                 chunk=8, device=CPU)
    k1, k2 = spmv.sliced_ell_sub_mrhs_plain.calls, trsv.trsv_apply_plain.calls
    spmv.sliced_ell_sub_mrhs(A, torch.ones((30, 2), dtype=torch.float64))
    trsv.trsv_apply_mrhs(s, torch.ones((40, 2), dtype=torch.complex128))
    assert spmv.sliced_ell_sub_mrhs_plain.calls == k1 + 1
    assert trsv.trsv_apply_plain.calls == k2 + 1


# ---------------------------------------------------------------------------
# the whole surface in c128 and c64


_OPERATORS = {"convdiff16": lambda: _shifted(convdiff2d(16)),
              "hermitian16": lambda: _hermitian(16, True),
              "csymmetric16": lambda: _hermitian(16, False)}


@pytest.fixture(scope="module", params=sorted(_OPERATORS))
def cfactored(request, tmp_path_factory):
    A = _OPERATORS[request.param]()
    M = JHIF().factorize(A, Options(**OPTS))
    precs = _carry(M, tmp_path_factory.mktemp(request.param))
    B = _crandn(np.random.default_rng(1), (A.nrows, 5))
    return request.param, A, M, precs, B


def test_operators_are_what_they_claim(cfactored):
    name, A, M, precs, B = cfactored
    S = A.to_scipy()
    assert np.iscomplexobj(S.data) and precs[0].d.dtype == np.complex128
    herm = abs(S - S.conj().T).max() == 0
    symm = abs(S - S.T).max() == 0
    assert (herm, symm) == {"convdiff16": (False, False),
                            "hermitian16": (True, False),
                            "csymmetric16": (False, True)}[name]
    assert M.precs[-1].dense_solver.kind == (
        "syeig" if name == "hermitian16" else "qrcp")


def _jax_pack(M, dense_inv):
    jdp = JDevicePrec.from_host(M.precs, dense_inv=dense_inv)
    jdp.pack_transpose(M.precs, dense_inv=dense_inv)
    jdp.pack_prod(M.precs)
    jdp.pack_prod_tran(M.precs)
    return jdp


@pytest.mark.parametrize("dense_inv", [0, 16, 32, "auto"])
def test_surface_c128_matches_jax_and_host(cfactored, dense_inv):
    """Forward and adjoint solves (a block and one vector), the runtime
    rank, the constant-mode filter and the products both ways, in c128,
    against the JAX package's pack with ``dtype=None`` and the host HIF."""
    name, A, M, precs, B = cfactored
    dp = DevicePrec.from_host(precs, dense_inv=dense_inv, device=CPU)
    assert dp.dtype == torch.complex128
    dp.pack_prod(precs)
    dp.pack_prod_tran(precs)
    jdp = _jax_pack(M, dense_inv)
    Bj = jnp.asarray(B)
    for trans in (False, True):
        X = dp.solve_mrhs(B, trans=trans)
        assert X.dtype == torch.complex128
        assert _rel(X, jdp.solve_mrhs(Bj, trans=trans)) <= 1e-10
        assert _rel(X, M.solve_mrhs(B, trans=trans)) <= 1e-10
        x = dp.solve(B[:, 0], trans=trans)
        assert x.shape == (A.nrows,)
        assert _rel(x, M.solve(B[:, 0], trans=trans)) <= 1e-10
        # the runtime rank, below the pack's
        r = max(dp.tail.rank - 1, 1)
        xr = dp.solve(B[:, 0], trans=trans, r=r)
        assert _rel(xr, jdp.solve(Bj[:, 0], trans=trans, r=r)) <= 1e-10
        assert _rel(xr, M.solve(B[:, 0], trans=trans, r=r)) <= 1e-10
        assert _rel(dp.solve_mrhs(B, trans=trans, r=r),
                    M.solve_mrhs(B, trans=trans, r=r)) <= 1e-10
        # the products, one vector and a block
        y = dp.mmultiply(B[:, 0], trans=trans)
        assert _rel(y, jdp.mmultiply(Bj[:, 0], trans=trans)) <= 1e-10
        assert _rel(y, M.mmultiply(B[:, 0], trans=trans)) <= 1e-10
        Bt = torch.from_numpy(B)
        Y = (prec_prod_tran_mrhs(dp.levels, dp.tran, dp.prod_tran, dp.tail,
                                 Bt) if trans
             else prec_prod_mrhs(dp.levels, dp.prod, dp.tail, Bt))
        for k in range(B.shape[1]):
            assert _rel(Y[:, k], M.mmultiply(B[:, k], trans=trans)) <= 1e-10
    # the constant-mode null-space filter subtracts the complex mean
    dp.nsp, M.nsp, jdp.nsp = ht.NspFilter(), JNspFilter(), JNspFilter()
    try:
        x = dp.solve(B[:, 0])
        X = dp.solve_mrhs(B)
        assert _rel(x, M.solve(B[:, 0])) <= 1e-10
        assert _rel(x, jdp.solve(Bj[:, 0])) <= 1e-10
        assert _rel(X, jdp.solve_mrhs(Bj)) <= 1e-10
    finally:
        dp.nsp = M.nsp = jdp.nsp = None
    assert abs(complex(x.mean())) < 1e-12 * float(x.abs().max())
    assert float(X.mean(dim=0).abs().max()) < 1e-12 * float(X.abs().max())


@pytest.mark.parametrize("dense_inv", [0, "auto"])
def test_surface_c64_within_gate(cfactored, dense_inv):
    """c64 packs: forward and adjoint solves and products within 1e-4 of
    the c128 JAX result."""
    name, A, M, precs, B = cfactored
    dp = DevicePrec.from_host(precs, dtype=np.complex64, dense_inv=dense_inv,
                              device=CPU)
    assert dp.dtype == torch.complex64
    dp.pack_prod(precs)
    dp.pack_prod_tran(precs)
    jdp = _jax_pack(M, dense_inv)
    Bj = jnp.asarray(B)
    for trans in (False, True):
        X = dp.solve_mrhs(B, trans=trans)
        assert X.dtype == torch.complex64
        assert _rel(X, jdp.solve_mrhs(Bj, trans=trans)) <= 1e-4
        y = dp.mmultiply(B[:, 0], trans=trans)
        assert _rel(y, jdp.mmultiply(Bj[:, 0], trans=trans)) <= 1e-4


def test_complex_host_refuses_a_real_pack(cfactored):
    name, A, M, precs, B = cfactored
    with pytest.raises(TypeError, match="packs as complex64 or complex128"):
        DevicePrec.from_host(precs, dtype=np.float64, device=CPU)
    assert ht.HIF(precs).to_device(device=CPU).dtype == torch.complex128


@pytest.mark.parametrize("dense_inv", [0, "auto"])
def test_conjugation_is_exercised(cfactored, dense_inv):
    """<Y, M^-1 X> = <M^-H Y, X> for every column pair (<a, b> = a^H b).
    On the nonsymmetric operator the pairings an adjoint without its
    conjugate (M^-T Y) or one on the forward operands (M^-1 Y) would give
    both fail, so the identity would catch either."""
    name, A, M, precs, B = cfactored
    dp = DevicePrec.from_host(precs, dense_inv=dense_inv, device=CPU)
    dp.pack_transpose(precs)
    X = torch.from_numpy(B)
    Y = torch.from_numpy(_crandn(np.random.default_rng(9), B.shape))
    MX = dp.solve_mrhs(X)
    lhs = Y.mH @ MX
    scale = (torch.linalg.vector_norm(Y, dim=0)[:, None]
             * torch.linalg.vector_norm(MX, dim=0)[None, :])

    def worst(Z):
        return float(((lhs - Z.mH @ X).abs() / scale).max())

    MHY = dp.solve_mrhs(Y, trans=True)
    assert worst(MHY) <= 1e-10
    if name == "convdiff16":
        MTY = dp.solve_mrhs(Y.conj(), trans=True).conj()     # M^-T Y
        assert worst(MTY) > 1e-3
        assert worst(dp.solve_mrhs(Y)) > 1e-3


def test_conj_view_inputs_are_resolved(cfactored):
    """A lazy conjugate view passed to the entry points gives the answer
    its values give."""
    name, A, M, precs, B = cfactored
    dp = DevicePrec.from_host(precs, device=CPU)
    Bc = torch.from_numpy(B.conj().copy())
    view = torch.from_numpy(B).conj()
    assert view.is_conj()
    assert torch.equal(dp.solve_mrhs(view), dp.solve_mrhs(Bc))
    At = spmv.sliced_ell_from_csr(_port(A), device=CPU)
    assert torch.equal(ht.ir_apply(At, dp, view[:, 0], 2),
                       ht.ir_apply(At, dp, Bc[:, 0], 2))


# ---------------------------------------------------------------------------
# refinement and GMRES


def test_ir_apply_c128_matches_jax(cfactored):
    name, A, M, precs, B = cfactored
    dp = DevicePrec.from_host(precs, device=CPU)
    jdp = JDevicePrec.from_host(M.precs)
    At = spmv.sliced_ell_from_csr(_port(A), device=CPU)
    Aj = jspmv.sliced_ell_from_csr(A)
    r = max(dp.tail.rank - 1, 1)
    X = ht.ir_apply(At, dp, B, 3)      # a block: each column as alone
    for k in range(2):
        for kw, jkw in (({}, {}), (dict(r=r), dict(r=jnp.int32(r)))):
            x = ht.ir_apply(At, dp, B[:, k], 3, **kw)
            xj = ir_apply_device(Aj, jdp.levels, jdp.tail,
                                 jnp.asarray(B[:, k]), 3, **jkw)
            assert x.shape == (A.nrows,) and _rel(x, xj) <= 1e-10
            if not kw:
                assert _rel(X[:, k], xj) <= 1e-10
    if name == "convdiff16":
        # refinement lowers the residual below the plain M-solve's (on the
        # Hermitian operator the truncated tail leaves I - A M^-1 above 1)
        b = B[:, 0]
        r1 = np.linalg.norm(b - A.matvec(dp.solve(b).numpy()))
        r3 = np.linalg.norm(b - A.matvec(X[:, 0].numpy()))
        assert r3 < r1


def test_gmres_mrhs_c128_matches_jax(cfactored):
    """Batched GMRES on complex columns (one zero, which stays zero): flag
    and cycles equal to the JAX package's batched driver, which conjugates
    its rotations as the port does."""
    name, A, M, precs, B = cfactored
    dp = DevicePrec.from_host(precs, device=CPU)
    jdp = JDevicePrec.from_host(M.precs)
    At = spmv.sliced_ell_from_csr(_port(A), device=CPU)
    Aj = jspmv.sliced_ell_from_csr(A)
    Bz = B.copy()
    Bz[:, 3] = 0
    X, flag, cycles = ht.gmres_mrhs(At, dp, Bz, restart=3, rtol=1e-8)
    Xj, flagj, cyclesj = gmres_mrhs_device(Aj, jdp, jnp.asarray(Bz),
                                           restart=3, rtol=1e-8)
    assert (flag, cycles) == (flagj, cyclesj) and flag == 0 and cycles > 1
    assert X.dtype == torch.complex128 and _rel(X, Xj) <= 1e-8
    assert not X[:, 3].any()
    for k in (0, 1, 2, 4):
        assert (np.linalg.norm(Bz[:, k] - A.matvec(X[:, k].numpy()))
                <= 1e-8 * np.linalg.norm(Bz[:, k]))


@pytest.mark.parametrize("driver", ["gmres_hif", "fgmres_hifir"])
def test_gmres_single_c128_true_residual(cfactored, driver):
    """The single-RHS drivers converge to a true residual within 1.01 rtol.
    Their iteration counts are not held to the JAX package's: its
    single-RHS Givens step (``hifir_tpu/solvers/gmres.py:93-101``) takes
    ``sqrt(a*a + b*b)`` and ``a / rho`` without conjugates, a rotation
    that is complex orthogonal and not unitary, so its |g[j+1]| is not the
    residual norm on complex input; the port's rotation conjugates."""
    name, A, M, precs, B = cfactored
    dp = DevicePrec.from_host(precs, device=CPU)
    At = spmv.sliced_ell_from_csr(_port(A), device=CPU)
    b, rtol = B[:, 1], 1e-8
    if driver == "gmres_hif":
        x, flag, it = ht.gmres_hif(At, dp, b, restart=4, rtol=rtol)
    else:
        x, flag, it = ht.fgmres_hifir(At, dp, b, restart=3, rtol=rtol,
                                      rank=dp.tail.rank)
    assert x.dtype == torch.complex128 and flag == 0 and it > 1
    res = np.linalg.norm(b - A.matvec(x.numpy())) / np.linalg.norm(b)
    assert res <= 1.01 * rtol
    # c64 converges too, to a single-precision tolerance
    dp64 = DevicePrec.from_host(precs, dtype=np.complex64, device=CPU)
    A64 = spmv.sliced_ell_from_csr(_port(A), dtype=np.complex64, device=CPU)
    x64, flag64, _ = ht.gmres_hif(A64, dp64, b, restart=4, rtol=1e-5)
    res64 = (np.linalg.norm(b - A.matvec(x64.numpy().astype(np.complex128)))
             / np.linalg.norm(b))
    assert flag64 == 0 and res64 <= 1e-4


# ---------------------------------------------------------------------------
# dense tails


def _m0_payload_c(kind, n=8, seed=0):
    """A complex one-level preconditioner with m == 0 (everything is the
    dense tail): a complex D, Hermitian for SYEIG."""
    rng = np.random.default_rng(seed)
    D = _crandn(rng, (n, n)) + n * np.eye(n)
    if kind == "syeig":
        D = D + D.conj().T
    empty = dict(indptr=np.zeros(1, np.int64), indices=np.empty(0, np.int32),
                 data=np.empty(0, np.complex128))
    pay = {"nlevels": np.int64(1), "stats": np.zeros(1),
           "l0_mn": np.array([0, n]), "l0_dense": D,
           "l0_dense_kind": np.array(kind)}
    for f, shape in (("L_B", (0, 0)), ("U_B", (0, 0)), ("E", (n, 0)),
                     ("F", (0, n))):
        pay.update({f"l0_{f}_{k}": v for k, v in empty.items()})
        pay[f"l0_{f}_indptr"] = np.zeros(shape[0] + 1, np.int64)
        pay[f"l0_{f}_shape"] = np.array(shape)
    pay.update(l0_d=np.empty(0, np.complex128), l0_s=np.ones(n),
               l0_t=np.ones(n), l0_p=np.arange(n), l0_p_inv=np.arange(n),
               l0_q=np.arange(n), l0_q_inv=np.arange(n))
    return pay, D


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("kind", ["qrcp", "syeig", "lup"])
def test_complex_dense_tails(tmp_path, kind, trans):
    """A complex payload loads without losing its dtype (the levels above
    the tail have no rows), and its QRCP, SYEIG (real eigenvalues) and LUP
    tails solve and multiply, both ways, against exact dense solves; the
    runtime rank against the JAX package's pack in complex128."""
    pay, D = _m0_payload_c(kind)
    path = tmp_path / "m0c.npz"
    np.savez(path, **pay)
    M = ht.load_prec(str(path))
    ds = M.precs[-1].dense_solver
    assert M.precs[-1].dense_matrix.dtype == np.complex128
    if kind == "syeig":
        assert ds.w.dtype == np.float64 and ds.V.dtype == np.complex128
    dp = M.to_device(device=CPU)
    assert dp.dtype == torch.complex128
    dp.pack_transpose(M.precs)
    dp.pack_prod(M.precs)
    dp.pack_prod_tran(M.precs)
    B = _crandn(np.random.default_rng(5), (8, 3))
    Dt = D.conj().T if trans else D
    assert _rel(dp.solve_mrhs(B, trans=trans), np.linalg.solve(Dt, B)) <= 1e-10
    assert _rel(dp.mmultiply(B[:, 0], trans=trans), Dt @ B[:, 0]) <= 1e-10
    jdp = jload_prec(str(path)).to_device(dtype=np.complex128)
    jdp.pack_transpose(jload_prec(str(path)).precs, dtype=np.complex128)
    X5 = dp.solve_mrhs(B, trans=trans, r=5)
    assert _rel(X5, jdp.solve_mrhs(jnp.asarray(B), trans=trans, r=5)) <= 1e-10
    if kind != "lup":
        assert _rel(X5, dp.solve_mrhs(B, trans=trans)) > 1e-3


# ---------------------------------------------------------------------------
# the complex nonsymmetric fixture


def test_shift_diagonal_copy_equal_reference():
    A, J = shift_diagonal(tconvdiff2d(9, 7)), _shifted(convdiff2d(9, 7))
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(A, f), getattr(J, f))
    assert A.data.dtype == np.complex128


def test_complex_fixture_loads_like_reference():
    """``hifir_tpu_torch/data/convdiff2d_128_c_prec.npz`` was written by the
    JAX package::

        python -c "import numpy as np, scipy.sparse as sp; \\
        from hifir_tpu.api import HIF; from hifir_tpu.ds.csr import CSR; \\
        from hifir_tpu.models import convdiff2d; \\
        from hifir_tpu.options import Options; \\
        from hifir_tpu.utils.serialize import save_prec; \\
        S = convdiff2d(128).to_scipy().astype(np.complex128); \\
        A = CSR.from_scipy(S + (-0.1 + 0.1j) * sp.diags(abs(S.diagonal()))); \\
        save_prec('hifir_tpu_torch/data/convdiff2d_128_c_prec.npz', \\
        HIF().factorize(A, Options(tau_L=1e-2, tau_U=1e-2, alpha_L=3, \\
        alpha_U=3, kappa=3, kappa_d=3, dense_thres=600, verbose=0)))"

    Its operator (``shift_diagonal(convdiff2d(128))`` in the port) is
    neither symmetric nor Hermitian, so an adjoint that transposes without
    conjugating fails on it, and so does one on the forward operands."""
    M = ht.load_prec(FIXTURE)
    J = jload_prec(FIXTURE)
    assert [(p.m, p.n) for p in M.precs] == [(13085, 16384), (3274, 3299)]
    assert M.nnz() == J.nnz() == 214310
    for p, jp in zip(M.precs, J.precs):
        assert p.d.dtype == p.E.data.dtype == np.complex128
        for f in ("d", "s", "t", "p", "p_inv", "q", "q_inv"):
            np.testing.assert_array_equal(getattr(p, f), getattr(jp, f))
        for f in ("L_B", "U_B", "E", "F"):
            a, b = getattr(p, f), getattr(jp, f)
            assert a.shape == b.shape
            for g in ("indptr", "indices", "data"):
                np.testing.assert_array_equal(getattr(a, g), getattr(b, g))
    ds, jds = M.precs[-1].dense_solver, J.precs[-1].dense_solver
    assert (ds.kind, ds.rank, ds.n) == ("qrcp", 25, 25)
    for f in ("Q", "R", "jpvt"):
        np.testing.assert_array_equal(getattr(ds, f), getattr(jds, f))
    S = shift_diagonal(tconvdiff2d(128)).to_scipy()
    assert abs(S - S.T).max() > 1e-3 and abs(S - S.conj().T).max() > 1e-3
