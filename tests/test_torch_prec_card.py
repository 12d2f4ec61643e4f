"""The preconditioner's surface on the card, each call against the port's
plain CPU run (or a check that needs no reference), with its launches.

- Main path, on the frozen fixture (``benchdata/frozen_prec.npz``,
  poisson2d(128)): the batched M-solve of 128 right-hand sides on packs
  ``dense_inv`` "auto" and 0 in f32 and f64 (1e-4 / 1e-10 of max|X|), K1
  and K2 launched as the pack's forms say; HIFIR nirs = 1..4 with
  A = BSR(poisson2d(128)): the residual falls every step for every column,
  K7 three times at nirs = 4, the result within 1e-10 of the CPU run.
- Surface, on the nonsymmetric fixture and A = convdiff2d(128): forward
  and adjoint M-solves on the four packs, the adjoint identity, the
  runtime rank both ways, a null-space filter, the products M X and M^H X
  (K1's sign +1 launches counted), M (M^-1 B) = B, and the three GMRES
  drivers (flag 0, true residual within 1.01 rtol, counts within one of
  the CPU run).
- Complex, on the complex fixture and A = shift_diagonal(convdiff2d(128)):
  the same parts in c64 and c128 (the adjoint identity also fails
  unconjugated), none launching K7 or calling a plain version on the card.
- Saddle point: bench.py's mixed-precision IR on saddle_point_stokes(64).

Seeds: the main path draws after the kernel rows (``default_rng(0)``), the
surface from ``default_rng(1)``, the complex parts from
``default_rng(2)`` after the complex kernel rows, the saddle point from
``default_rng(5)``.  Every test needs an NVIDIA GPU and skips without one;
on the card: ``python3 -m pytest tests/test_torch_prec_card.py -q
--noconftest``.
"""

import types

import numpy as np
import pytest
import torch

import hifir_tpu_torch as ht
from card_common import (CONVDIFF, CONVDIFF_C, CPLX, FIXTURE, NRHS, SEED,
                         complex_draws, counted, draw, host_rel, main_rhs,
                         skip_without_card, solve_forms, want_launches)
from hifir_tpu_torch.models.problems import (convdiff2d, poisson2d,
                                             saddle_point_stokes,
                                             shift_diagonal)
from hifir_tpu_torch.ops.bsr_spmv import bsr_from_csr
from hifir_tpu_torch.ops.spmv import ell_matvec_mrhs, sliced_ell_from_csr

pytestmark = pytest.mark.card


@pytest.fixture(scope="module", autouse=True)
def card():
    skip_without_card()


PACKS = [(di, dt) for di in ("auto", 0) for dt in ("float32", "float64")]
CPACKS = [(di, dt) for di in ("auto", 0) for dt in CPLX]
SOLVE_TOL = {"float32": 1e-4, "float64": 1e-10, "complex64": 1e-4,
             "complex128": 1e-10}


def pid(p):
    return f"dense_inv={p[0]}-{p[1]}"


def check_solve(dp, X, per, ref, dt, trans, n):
    """An M-solve of 128 columns: finite, its shape and dtype, within the
    dtype's tolerance of the CPU run, K1 and K2 launched as the pack's
    forms say."""
    real = torch.view_as_real(X) if X.is_complex() else X
    assert bool(torch.isfinite(real).all())
    assert tuple(X.shape) == (n, NRHS) and X.dtype == dp.dtype
    d = host_rel(X, ref)
    assert d <= SOLVE_TOL[dt], f"{d:.3e} > {SOLVE_TOL[dt]}"
    want = want_launches(solve_forms(dp, trans))
    assert {k: per[k] for k in want} == want


def want_plus(dp, trans) -> int:
    """K1 launches with sign +1 that one product must make: L and U of
    every level with entries, and E (F^H for the adjoint) where the level
    has tail rows."""
    if not trans:
        return sum((pl.Lell.nnz > 0) + (pl.Uell.nnz > 0)
                   + (lv.n > lv.m and lv.E.nnz > 0)
                   for lv, pl in zip(dp.levels, dp.prod))
    return sum((pt.LellH.nnz > 0) + (pt.UellH.nnz > 0)
               + (lv.n > lv.m and t.FT.nnz > 0)
               for lv, t, pt in zip(dp.levels, dp.tran, dp.prod_tran))


def prod(p, X, trans):
    """M X (``trans``: M^H X) on pack ``p`` through the module functions."""
    from hifir_tpu_torch.alg.prec import prec_prod_mrhs, prec_prod_tran_mrhs

    if trans:
        return prec_prod_tran_mrhs(p.levels, p.tran, p.prod_tran, p.tail, X)
    return prec_prod_mrhs(p.levels, p.prod, p.tail, X)


# ---------------------------------------------------------------------------
# main path

@pytest.fixture(scope="module")
def main():
    M, Mc = ht.load_prec(FIXTURE), ht.load_prec(CONVDIFF)
    A = poisson2d(128)
    B = main_rhs(M, Mc)
    # the reference: the port's plain f64 solve on the CPU, level-scan form
    cpu = M.to_device(dtype=np.float64, device="cpu", dense_inv=0)
    Ab_cpu = bsr_from_csr(A, bs=128, dtype=np.float64, device="cpu")
    packs = {(di, dt): M.to_device(dtype=np.dtype(dt), dense_inv=di)
             for di, dt in PACKS}
    return types.SimpleNamespace(
        M=M, A=A, B=B, ref=cpu.solve_mrhs(B).numpy(),
        ir_ref=ht.ir_apply(Ab_cpu, cpu, B, 4).numpy(), packs=packs,
        Ab=bsr_from_csr(A, bs=128, dtype=np.float64),
        Bd={dt: torch.as_tensor(B, dtype=getattr(torch, dt), device="cuda")
            for dt in ("float32", "float64")})


@pytest.mark.parametrize("pack", PACKS, ids=pid)
def test_main_solve(pack, main):
    di, dt = pack
    dp = main.packs[pack]
    X, per, _ = counted(lambda: dp.solve_mrhs(main.Bd[dt]))
    check_solve(dp, X, per, main.ref, dt, False, main.M.precs[0].n)
    assert per["K1"] > 0
    if di == 0:
        assert per["K2"] > 0   # 8 a dense_inv=0 M-solve on the fixture


def test_main_hifir(main):
    """HIFIR with A as BSR, f64: K7 three times at nirs = 4, the residual
    falls every step for every column, the result within 1e-10 of the
    CPU's plain refinement."""
    dp, Bt = main.packs[("auto", "float64")], main.Bd["float64"]
    Xs = [ht.ir_apply(main.Ab, dp, Bt, k) for k in range(1, 4)]
    X4, per, _ = counted(lambda: ht.ir_apply(main.Ab, dp, Bt, 4))
    Xs.append(X4)
    assert per["K7"] == 3
    res = np.array([torch.linalg.vector_norm(
        Bt - ell_matvec_mrhs(main.Ab, Xk), dim=0).cpu().numpy()
        for Xk in Xs])
    assert np.all(res[1:] < res[:-1])
    rel = np.abs(X4.cpu().numpy() - main.ir_ref).max() / np.abs(
        main.ir_ref).max()
    assert rel <= 1e-10


# ---------------------------------------------------------------------------
# surface: the nonsymmetric fixture

@pytest.fixture(scope="module")
def surface():
    M = ht.load_prec(CONVDIFF)
    A = convdiff2d(128)
    n = A.nrows
    rng = np.random.default_rng(SEED["surface"])
    B, Y = draw(rng, [(n, NRHS), (n, NRHS)])
    cpu = M.to_device(dtype=np.float64, device="cpu", dense_inv=0)
    cpu.pack_transpose(M.precs)
    packs = {}
    for di, dt in PACKS:
        dp = packs[(di, dt)] = M.to_device(dtype=np.dtype(dt), dense_inv=di,
                                           device="cuda")
        dp.pack_transpose(M.precs)
    return types.SimpleNamespace(
        M=M, A=A, n=n, B=B, Y=Y, cpu=cpu, packs=packs,
        rank=M.precs[-1].dense_solver.rank,
        ref={t: cpu.solve_mrhs(B, trans=t).numpy() for t in (False, True)},
        Bd={dt: torch.as_tensor(B, dtype=getattr(torch, dt), device="cuda")
            for dt in ("float32", "float64")})


@pytest.fixture(scope="module")
def surface_prods(surface):
    """The ``auto`` f64 pack and the CPU pack with their products packed."""
    dp = surface.packs[("auto", "float64")]
    for p in (dp, surface.cpu):
        p.pack_prod(surface.M.precs)
        p.pack_prod_tran(surface.M.precs)
    return dp


@pytest.mark.parametrize("trans", [False, True], ids=["forward", "adjoint"])
@pytest.mark.parametrize("pack", PACKS, ids=pid)
def test_surface_solve(pack, trans, surface):
    di, dt = pack
    dp = surface.packs[pack]
    X, per, _ = counted(lambda: dp.solve_mrhs(surface.Bd[dt], trans=trans))
    check_solve(dp, X, per, surface.ref[trans], dt, trans, surface.n)
    assert per["K1"] > 0
    if di == 0:
        assert per["K2"] > 0


@pytest.mark.parametrize("di", ["auto", 0])
def test_surface_adjoint_identity(di, surface):
    """<Y, M^-1 X> = <M^-H Y, X> for every column pair, in f64."""
    dp = surface.packs[(di, "float64")]
    Y = torch.as_tensor(surface.Y, dtype=torch.float64, device="cuda")
    Bt = surface.Bd["float64"]
    MX = dp.solve_mrhs(Bt)
    lhs = Y.T @ MX
    rhs = dp.solve_mrhs(Y, trans=True).T @ Bt
    scale = (torch.linalg.vector_norm(Y, dim=0)[:, None]
             * torch.linalg.vector_norm(MX, dim=0)[None, :])
    assert float(((lhs - rhs).abs() / scale).max()) <= 1e-10


@pytest.mark.parametrize("trans", [False, True], ids=["forward", "adjoint"])
def test_surface_rank(trans, surface):
    """r = the tail's rank equals the pack's rank; r = 3/4 of it matches
    the CPU and changes the solve."""
    dp = surface.packs[("auto", "float64")]
    B8 = surface.Bd["float64"][:, :8]
    rank = surface.rank
    r = round(0.75 * rank)
    X = dp.solve_mrhs(B8, trans=trans)
    assert host_rel(dp.solve_mrhs(B8, trans=trans, r=rank), X.cpu()) <= 1e-12
    Xr = dp.solve_mrhs(B8, trans=trans, r=r)
    assert host_rel(Xr, surface.cpu.solve_mrhs(surface.B[:, :8], trans=trans,
                                               r=r)) <= 1e-10
    assert host_rel(Xr, X.cpu()) > 1e-8


@pytest.mark.parametrize("trans", [False, True], ids=["forward", "adjoint"])
def test_surface_nsp(trans, surface):
    """A constant-mode null-space filter on every column."""
    dp = surface.packs[("auto", "float64")]
    dp.nsp, dp.nsp_tran = ht.NspFilter(), ht.NspFilter()
    try:
        X = dp.solve_mrhs(surface.Bd["float64"], trans=trans)
    finally:
        dp.nsp = dp.nsp_tran = None
    assert float(X.mean(dim=0).abs().max() / X.abs().max()) <= 1e-12


@pytest.mark.parametrize("trans", [False, True], ids=["M", "MH"])
@pytest.mark.parametrize("k", [8, NRHS])
def test_surface_products(k, trans, surface, surface_prods):
    dp = surface_prods
    Xk = surface.Bd["float64"][:, :k].contiguous()
    Yk, per, _ = counted(lambda: prod(dp, Xk, trans))
    ref = prod(surface.cpu, torch.as_tensor(surface.B[:, :k]), trans)
    assert host_rel(Yk, ref) <= 1e-10
    assert per["K1plus"] == want_plus(dp, trans) > 0


@pytest.mark.parametrize("trans", [False, True], ids=["M", "MH"])
def test_surface_product_inverts_solve(trans, surface, surface_prods):
    dp, Bt = surface_prods, surface.Bd["float64"]
    err = float(torch.linalg.norm(prod(dp, dp.solve_mrhs(Bt, trans=trans),
                                       trans) - Bt) / torch.linalg.norm(Bt))
    assert err <= 1e-9


def gmres_drivers(rank, restart=None):
    kw = {} if restart is None else dict(restart=restart)
    return {
        "gmres_hif": lambda A, p, B: ht.gmres_hif(A, p, B[:, 0], rtol=1e-6,
                                                  **kw),
        "fgmres_hifir": lambda A, p, B: ht.fgmres_hifir(
            A, p, B[:, 0], rtol=1e-6, rank=rank, **kw),
        "gmres_mrhs": lambda A, p, B: ht.gmres_mrhs(A, p, B, rtol=1e-6,
                                                    **kw),
    }


def check_gmres(name, x, flag, it, A, B, cpu_run):
    """flag 0, the true residual within 1.01 rtol (on the host, from the
    CSR A) and the count within one of the plain CPU run's."""
    _, _, it_c = cpu_run
    X = x.cpu().numpy().reshape(B.shape[0], -1)
    Bk = B[:, :X.shape[1]]
    res = (np.linalg.norm(Bk - A.to_scipy() @ X, axis=0)
           / np.linalg.norm(Bk, axis=0))
    assert flag == 0
    assert float(res.max()) <= 1.01e-6
    assert abs(it - it_c) <= 1, f"{name}: {it} against the CPU run's {it_c}"


@pytest.mark.parametrize("name", ["gmres_hif", "fgmres_hifir", "gmres_mrhs"])
def test_surface_gmres(name, surface, surface_prods):
    """The GMRES drivers, f64, sliced-ELL A (BSR for gmres_mrhs, which
    launches K7), against the plain CPU runs of the same pack form."""
    A = surface.A
    form = (lambda d: bsr_from_csr(A, bs=128, device=d)) \
        if name == "gmres_mrhs" else \
        (lambda d: sliced_ell_from_csr(A, device=d))
    drive = gmres_drivers(surface.rank)[name]
    (x, flag, it), per, _ = counted(
        lambda: drive(form("cuda"), surface_prods, surface.B))
    cpu_auto = surface.M.to_device(dtype=np.float64, device="cpu")
    check_gmres(name, x, flag, it, A, surface.B,
                drive(form("cpu"), cpu_auto, surface.B))
    if name == "gmres_mrhs":
        assert per["K7"] >= 1


# ---------------------------------------------------------------------------
# complex: the complex nonsymmetric fixture

@pytest.fixture(scope="module")
def cplx():
    M = ht.load_prec(CONVDIFF_C)
    A = shift_diagonal(convdiff2d(128))
    n = A.nrows
    B, _, rng = complex_draws(M)
    (Y,) = draw(rng, [(n, NRHS)], cplx=True)
    cpu = M.to_device(dtype=np.complex128, device="cpu", dense_inv=0)
    cpu.pack_transpose(M.precs)
    packs = {}
    for di, dt in CPACKS:
        dp = packs[(di, dt)] = M.to_device(dtype=np.dtype(dt), dense_inv=di,
                                           device="cuda")
        dp.pack_transpose(M.precs)
    return types.SimpleNamespace(
        M=M, A=A, n=n, B=B, Y=Y, cpu=cpu, packs=packs,
        rank=M.precs[-1].dense_solver.rank,
        ref={t: cpu.solve_mrhs(B, trans=t).numpy() for t in (False, True)},
        Bd={dt: torch.as_tensor(B, dtype=getattr(torch, dt), device="cuda")
            for dt in CPLX})


@pytest.fixture(scope="module")
def cplx_prods(cplx):
    dp = cplx.packs[("auto", "complex128")]
    for p in (dp, cplx.cpu):
        p.pack_prod(cplx.M.precs)
        p.pack_prod_tran(cplx.M.precs)
    return dp


def on_card_only(per, plain):
    """A complex part launches no K7 (a complex A goes as sliced ELL) and
    calls no plain version on the card."""
    assert per["K7"] == 0 and plain == 0, (per, plain)


@pytest.mark.parametrize("trans", [False, True], ids=["forward", "adjoint"])
@pytest.mark.parametrize("pack", CPACKS, ids=pid)
def test_complex_solve(pack, trans, cplx):
    di, dt = pack
    dp = cplx.packs[pack]
    X, per, plain = counted(lambda: dp.solve_mrhs(cplx.Bd[dt], trans=trans))
    check_solve(dp, X, per, cplx.ref[trans], dt, trans, cplx.n)
    on_card_only(per, plain)
    assert per["K1"] > 0
    if di == 0:
        assert per["K2"] > 0


@pytest.mark.parametrize("di", ["auto", 0])
def test_complex_adjoint_identity(di, cplx):
    """<Y, M^-1 X> = <M^-H Y, X> (<a, b> = a^H b) for every column pair, and
    the pairing with M^-T Y, which an adjoint that dropped the conjugate
    would give, fails."""
    dp = cplx.packs[(di, "complex128")]
    Y = torch.as_tensor(cplx.Y, dtype=torch.complex128, device="cuda")
    X = cplx.Bd["complex128"]
    (MX, MHY, MTY), per, plain = counted(lambda: (
        dp.solve_mrhs(X), dp.solve_mrhs(Y, trans=True),
        dp.solve_mrhs(Y.conj(), trans=True).conj()))

    def pairing(Z):
        scale = (torch.linalg.vector_norm(Y, dim=0)[:, None]
                 * torch.linalg.vector_norm(MX, dim=0)[None, :])
        return float(((Y.mH @ MX - Z.mH @ X).abs() / scale).max())

    assert pairing(MHY) <= 1e-10
    assert pairing(MTY) > 1e-3, "the fixture cannot catch a lost conjugate"
    on_card_only(per, plain)


@pytest.mark.parametrize("trans", [False, True], ids=["forward", "adjoint"])
def test_complex_rank(trans, cplx):
    dp = cplx.packs[("auto", "complex128")]
    B8 = cplx.Bd["complex128"][:, :8]
    rank = cplx.rank
    r = round(0.75 * rank)
    (X, Xfull, Xr), per, plain = counted(lambda: (
        dp.solve_mrhs(B8, trans=trans),
        dp.solve_mrhs(B8, trans=trans, r=rank),
        dp.solve_mrhs(B8, trans=trans, r=r)))
    assert host_rel(Xfull, X) <= 1e-12
    assert host_rel(Xr, cplx.cpu.solve_mrhs(cplx.B[:, :8], trans=trans,
                                            r=r)) <= 1e-10
    assert host_rel(Xr, X) > 1e-8
    on_card_only(per, plain)


@pytest.mark.parametrize("trans", [False, True], ids=["M", "MH"])
@pytest.mark.parametrize("k", [8, NRHS])
def test_complex_products(k, trans, cplx, cplx_prods):
    dp = cplx_prods
    Xk = cplx.Bd["complex128"][:, :k].contiguous()
    Yk, per, plain = counted(lambda: prod(dp, Xk, trans))
    assert host_rel(Yk, prod(cplx.cpu, torch.as_tensor(cplx.B[:, :k]),
                             trans)) <= 1e-10
    assert per["K1plus"] == want_plus(dp, trans)
    on_card_only(per, plain)


@pytest.mark.parametrize("trans", [False, True], ids=["M", "MH"])
def test_complex_product_inverts_solve(trans, cplx, cplx_prods):
    dp, Bt = cplx_prods, cplx.Bd["complex128"]
    err, per, plain = counted(lambda: float(torch.linalg.norm(
        prod(dp, dp.solve_mrhs(Bt, trans=trans), trans) - Bt)
        / torch.linalg.norm(Bt)))
    assert err <= 1e-9
    on_card_only(per, plain)


@pytest.mark.parametrize("name", ["gmres_hif", "fgmres_hifir", "gmres_mrhs"])
def test_complex_gmres(name, cplx, cplx_prods):
    """c128, restart 10, a sliced-ELL A (K1 only), against the plain CPU
    runs."""
    A = cplx.A
    drive = gmres_drivers(cplx.rank, restart=10)[name]
    (x, flag, it), per, plain = counted(lambda: drive(
        sliced_ell_from_csr(A, device="cuda"), cplx_prods, cplx.B))
    cpu_auto = cplx.M.to_device(dtype=np.complex128, device="cpu")
    check_gmres(name, x, flag, it, A, cplx.B,
                drive(sliced_ell_from_csr(A, device="cpu"), cpu_auto,
                      cplx.B))
    on_card_only(per, plain)


# ---------------------------------------------------------------------------
# saddle point

def test_saddle_point_ir():
    """bench.py's correctness leg: the port's native factorize of
    saddle_point_stokes(64), packed in f32, 10 Richardson steps with the
    f64 residual on the host and the M-solve on the card; the median
    contraction of the first 5 steps below 0.5, K1 and K2 launched as the
    pack's forms say (no K2: its levels are all blocked)."""
    A = saddle_point_stokes(64)
    n = A.nrows
    P = ht.HIF().factorize(A, ht.Options(verbose=0))
    dp = P.to_device(dtype=np.float32)
    b = np.random.default_rng(SEED["saddle"]).standard_normal(n)
    rn = [float(np.linalg.norm(b))]

    def steps():
        x = np.zeros(n)
        for _ in range(10):
            r = torch.as_tensor((b - A.matvec(x))[:, None],
                                dtype=torch.float32, device="cuda")
            x = x + dp.solve_mrhs(r)[:, 0].double().cpu().numpy()
            rn.append(float(np.linalg.norm(b - A.matvec(x))))

    _, per, _ = counted(steps)
    ratios = [rn[i + 1] / rn[i] for i in range(10) if rn[i] > 0]
    assert float(np.median(ratios[:5])) < 0.5
    want = want_launches(solve_forms(dp, False))
    assert {k: per[k] for k in want} == {k: 10 * v for k, v in want.items()}
    assert per["K1"] > 0
