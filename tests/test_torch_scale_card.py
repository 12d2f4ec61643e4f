"""The robust configurations at their real size on the card: poisson2d(1024)
(n = 1,048,576, BASELINE config 2) at 64 right-hand sides and
poisson3d(64) (n = 262,144) at 128 with the f64 adjoint.

Each cell: the port's native factorize with ``Options(verbose=0)``, packs
``auto`` in f32 and f64, the device M-solve at the block's width and at one
column against the host's native f64 single-RHS solves of 8 columns spread
over the block (1e-4 / 1e-10 of max|X|; the host's 2-D ``solve_mrhs`` takes
tens of seconds at these sizes) with K1 and K2 launched as the packs' forms
say, and gmres_hif with a sliced-ELL A and the device M (f64) against the
host gmres_np with the host M (restart 30, rtol 1e-6, one right-hand side:
flag 0, true residual within 1.01 rtol, counts within one).  The 1M cell
also refines by HIFIR nirs = 4 in f64 with A as sliced ELL: the residual
falls every step for every column.

Seeds: ``default_rng(4)`` (1M) and ``default_rng(9)`` (3-D), the block
first.  Every test needs an NVIDIA GPU and skips without one; on the card:
``python3 -m pytest tests/test_torch_scale_card.py -q --noconftest``.
"""

import types

import numpy as np
import pytest
import torch

import hifir_tpu_torch as ht
from card_common import (SEED, counted, skip_without_card, solve_forms,
                         want_launches)
from hifir_tpu_torch.models.problems import poisson2d, poisson3d
from hifir_tpu_torch.ops.spmv import sliced_ell_from_csr, sliced_ell_sub_mrhs
from hifir_tpu_torch.solvers.gmres_np import gmres_hif as host_gmres

pytestmark = pytest.mark.card


@pytest.fixture(scope="module", autouse=True)
def card():
    skip_without_card()


# cell: (matrix, seed, block width, the f64 adjoint too)
CELLS = {"1M": (lambda: poisson2d(1024), SEED["million"], 64, False),
         "3D": (lambda: poisson3d(64), SEED["poisson3d"], 128, True)}
RUNS = {cell: [("float32", w, False), ("float32", 1, False),
               ("float64", w, False), ("float64", 1, False)]
        + ([("float64", w, True)] if adjoint else [])
        for cell, (_, _, w, adjoint) in CELLS.items()}


@pytest.fixture(scope="module")
def cells():
    """Each cell's factorization, packs, block and host references, built
    at its first use."""
    built = {}

    def of(cell):
        if cell in built:
            return built[cell]
        make, seed, nrhs, adjoint = CELLS[cell]
        A = make()
        P = ht.HIF().factorize(A, ht.Options(verbose=0))
        B = np.random.default_rng(seed).standard_normal((A.nrows, nrhs))
        cols = np.linspace(0, nrhs - 1, 8).astype(int)
        ref = {trans: np.stack([P.solve(B[:, c], trans=trans) for c in cols],
                               axis=1)
               for trans in ((False, True) if adjoint else (False,))}
        packs = {dt: P.to_device(dtype=np.dtype(dt))
                 for dt in ("float32", "float64")}
        if adjoint:
            packs["float64"].pack_transpose(P.precs)
        Bd = {dt: torch.as_tensor(B, dtype=getattr(torch, dt), device="cuda")
              for dt in packs}
        built[cell] = types.SimpleNamespace(A=A, P=P, B=B, cols=cols, ref=ref,
                                            packs=packs, Bd=Bd)
        return built[cell]

    yield of
    built.clear()


@pytest.mark.parametrize("cell,run", [(c, r) for c in CELLS for r in RUNS[c]],
                         ids=lambda v: v if isinstance(v, str) else
                         f"{v[0]}-nrhs={v[1]}{'-adjoint' if v[2] else ''}")
def test_solve(cell, run, cells):
    c = cells(cell)
    dt, k, trans = run
    dp = c.packs[dt]
    n = c.A.nrows
    if k == 1:
        b = c.Bd[dt][:, 0].contiguous()
        X, per, _ = counted(lambda: dp.solve(b))
        assert tuple(X.shape) == (n,)
        ref, Xc = c.ref[trans][:, 0], X
    else:
        X, per, _ = counted(lambda: dp.solve_mrhs(c.Bd[dt], trans=trans))
        assert tuple(X.shape) == (n, k)
        ref = c.ref[trans]
        Xc = X[:, torch.as_tensor(c.cols, device=X.device)]
    assert bool(torch.isfinite(X).all())
    d = float(np.abs(Xc.double().cpu().numpy() - ref).max()
              / np.abs(ref).max())
    assert d <= (1e-4 if dt == "float32" else 1e-10), f"{d:.3e}"
    want = want_launches(solve_forms(dp, trans))
    assert {key: per[key] for key in want} == want


@pytest.mark.parametrize("cell", list(CELLS))
def test_gmres(cell, cells):
    """gmres_hif with the device M (f64) against the host gmres_np with the
    host M, on the same A and b."""
    c = cells(cell)
    As = sliced_ell_from_csr(c.A, device="cuda")
    b = c.B[:, 0]
    (x, flag, it), per, _ = counted(lambda: ht.gmres_hif(
        As, c.packs["float64"], b, restart=30, rtol=1e-6))
    _, flag_h, it_h = host_gmres(c.A, c.P, b, restart=30, rtol=1e-6)
    res = float(np.linalg.norm(b - c.A.matvec(x.cpu().numpy()))
                / np.linalg.norm(b))
    assert flag == 0 and flag_h == 0
    assert res <= 1.01e-6
    assert abs(it - it_h) <= 1, f"{it} iterations against the host's {it_h}"
    assert per["K1"] > 0 and per["K2"] > 0


def test_million_hifir(cells):
    """HIFIR nirs = 4, f64, 64 RHS, A as sliced ELL (K1 carries the
    residuals): K1 and K2 four solves' worth (K1 three more), no K7; the
    residual falls every step for every column."""
    c = cells("1M")
    dp, Bt = c.packs["float64"], c.Bd["float64"]
    As = sliced_ell_from_csr(c.A, device="cuda")
    Xs = [ht.ir_apply(As, dp, Bt, k) for k in range(1, 4)]
    X4, got, _ = counted(lambda: ht.ir_apply(As, dp, Bt, 4))
    Xs.append(X4)
    per = want_launches(solve_forms(dp, False))
    assert {k: got[k] for k in ("K7", "K1", "K2")} == dict(
        K7=0, K1=4 * per["K1"] + 3, K2=4 * per["K2"])
    rn = np.array([torch.linalg.vector_norm(sliced_ell_sub_mrhs(As, Xk, Bt),
                                            dim=0).cpu().numpy()
                   for Xk in Xs])
    assert np.all(rn[1:] < rn[:-1])
