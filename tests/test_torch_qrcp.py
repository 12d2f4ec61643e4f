"""K8 (the device QRCP of the dense tail) and the tail's rank rule, on the CPU.

The port's ``qrcp_device`` runs the same code on the CPU that it runs on the
card; here it is held to the JAX package's ``qrcp_device`` on the two
fixtures' tails and on ``tests/test_device.py``'s 40x40 rank-25 matrix.
Pivots and ranks must be equal.  Q and R are held within 1e-12 (f64) and
1e-5 (f32) of the JAX factors relative to their largest magnitude, up to
the sign of each reflector: Householder QR takes the sign of the
reflector from the sign of x_k, which on these tails is rounding noise at
some steps (|x_k| ~ 1e-17 against entries of order 1), so the two packages
may flip a column of Q and the matching row of R.  Where the rank is below n
the comparison stops at the rank: the trailing pivots are chosen among
columns whose downdated norms are rounding noise, where LAPACK's ``geqp3``
and the JAX sweep disagree too; R's leading rows are compared in the
original column order.

The rank rule: a runtime rank r with 0 < r <= rank truncates the tail; r <= 0
and r above the rank keep the pack's rank, as the host QRCP and SYEIG do
(``hifir_tpu/small_scale/dense.py``).  Its oracle is the host solve, not the
JAX device tail, which keeps r columns above the rank.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hifir_tpu.alg.prec import DevicePrec as JDevicePrec
from hifir_tpu.models import convdiff2d
from hifir_tpu.options import Options as JOptions
from hifir_tpu.small_scale.dense import DeviceQRCP as JDeviceQRCP
from hifir_tpu.small_scale.qrcp_device import qrcp_device as jqrcp_device
from hifir_tpu.small_scale.qrcp_device import qrcp_rank as jqrcp_rank
from hifir_tpu.utils.serialize import load_prec as jload_prec

import hifir_tpu_torch as ht
from hifir_tpu_torch.small_scale.dense import (QRCP, DeviceQRCP,
                                               make_dense_solver, solve_rank)
from hifir_tpu_torch.small_scale.qrcp_device import qrcp_device, qrcp_rank

from test_torch_factorize import (OPTS, _shifted, jax_factorize,
                                  port_factorize, singular_matrix)
from test_torch_prec import _m0_payload, _rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FROZEN = os.path.join(ROOT, "benchdata", "frozen_prec.npz")
CONVDIFF = os.path.join(ROOT, "hifir_tpu_torch", "data",
                        "convdiff2d_128_prec.npz")
CPU = "cpu"


def _rank25() -> np.ndarray:
    """``tests/test_device.py::test_device_qrcp_factorization``'s matrix."""
    rng = np.random.default_rng(0)
    n = 40
    U = rng.standard_normal((n, 25))
    V = rng.standard_normal((25, n))
    return U @ V


_TAILS = {
    "frozen360": lambda: jload_prec(FROZEN).precs[-1].dense_matrix,
    "convdiff203": lambda: jload_prec(CONVDIFF).precs[-1].dense_matrix,
    "rank25_40": _rank25,
}
# the numerical rank of each matrix (the fixtures' tails are full rank)
_LEAD = {"frozen360": 360, "convdiff203": 203, "rank25_40": 25}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(_TAILS))
def test_qrcp_device_matches_jax(name, dtype):
    D = _TAILS[name]().astype(dtype)
    Q, R, piv = qrcp_device(torch.from_numpy(D))
    Qj, Rj, pj = (np.asarray(a) for a in jqrcp_device(jnp.asarray(D)))
    assert Q.dtype == R.dtype == torch.from_numpy(D).dtype
    assert piv.dtype == torch.int64
    Q, R, piv = Q.numpy(), R.numpy(), piv.numpy()
    assert qrcp_rank(torch.from_numpy(R)) == jqrcp_rank(jnp.asarray(Rj))
    k = _LEAD[name]
    np.testing.assert_array_equal(piv[:k], pj[:k])
    if k == D.shape[0]:
        np.testing.assert_array_equal(piv, pj)
    s, sj = np.sign(np.diag(R))[:k], np.sign(np.diag(Rj))[:k]
    # R's leading rows in the original column order (R P^T = Q^T A)
    Ro, Roj = np.empty_like(R), np.empty_like(Rj)
    Ro[:, piv], Roj[:, pj] = R, Rj
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert _rel(Q[:, :k] * s, Qj[:, :k] * sj) <= tol
    assert _rel(Ro[:k] * s[:, None], Roj[:k] * sj[:, None]) <= tol
    # and the factorization itself
    assert _rel(Q @ R, D[:, piv]) <= 10 * tol
    assert np.abs(np.triu(R) - R).max() == 0


def test_qrcp_device_refuses_complex():
    calls = qrcp_device.calls
    with pytest.raises(TypeError, match="real only"):
        qrcp_device(torch.eye(4, dtype=torch.complex128))
    with pytest.raises(ValueError, match="square"):
        qrcp_device(torch.ones(3, 4, dtype=torch.float64))
    assert qrcp_device.calls == calls     # a refused call is not counted


def test_qrcp_rank_rule():
    R = torch.diag(torch.tensor([2.0, 1.0, 1e-13, 0.0], dtype=torch.float64))
    assert qrcp_rank(R) == 2
    assert qrcp_rank(R, rrqr_cond=1e15) == 3
    assert qrcp_rank(torch.zeros(3, 3)) == 0


@pytest.fixture(scope="module")
def convdiff_tail():
    """convdiff2d(24) factorized by both packages: a 52x52 QRCP tail."""
    A = convdiff2d(24)
    jo = JOptions(**dict(OPTS, dense_thres=120))
    J = jax_factorize(A, jo)
    P = port_factorize(A, jo)
    assert P.precs[-1].dense_solver.kind == "qrcp"
    b = np.random.default_rng(2).standard_normal(A.nrows)
    return A, jo, J, P, b


def test_tail_on_device_matches_jax(convdiff_tail):
    A, jo, J, P, b = convdiff_tail
    dp = P.to_device(dtype=np.float64, device=CPU, tail_on_device=True)
    jdp = JDevicePrec.from_host(J.precs, tail_on_device=True)
    assert dp.tail.kind == "qrcp" and dp.tail.rank == jdp.tail.rank
    assert _rel(dp.solve(b), jdp.solve(jnp.asarray(b))) <= 1e-10
    # the host-tail pack of the same levels solves the same system
    host = P.to_device(dtype=np.float64, device=CPU)
    assert _rel(dp.solve(b), host.solve(b)) <= 1e-10
    assert qrcp_device.calls > 0


def test_device_tail_option(convdiff_tail):
    """``Options(device_tail=1)`` factorizes the tail with K8 during
    ``factorize`` (as ``tests/test_device.py::test_device_tail_in_factorize``
    does with the JAX package)."""
    A, jo, J, P, b = convdiff_tail
    jo1 = JOptions(**dict(OPTS, dense_thres=120, device_tail=1))
    Pd = port_factorize(A, jo1, device=CPU)
    Jd = jax_factorize(A, jo1)
    ds = Pd.precs[-1].dense_solver
    assert isinstance(ds, DeviceQRCP)
    assert isinstance(Jd.precs[-1].dense_solver, JDeviceQRCP)
    assert ds.rank == P.precs[-1].dense_solver.rank
    assert ds.rank == Jd.precs[-1].dense_solver.rank
    np.testing.assert_array_equal(ds.jpvt, Jd.precs[-1].dense_solver.jpvt)
    xd = Pd.to_device(device=CPU).solve(b)
    xh = P.to_device(device=CPU).solve(b)
    assert _rel(xd, xh) <= 1e-8
    assert make_dense_solver(True, device=True).kind == "syeig"


def test_complex_tail_on_device_raises():
    A = _shifted(convdiff2d(16))
    P = port_factorize(A, JOptions(**dict(OPTS, dense_thres=30)))
    assert np.iscomplexobj(P.precs[-1].dense_matrix)
    with pytest.raises(TypeError, match="real only"):
        P.to_device(device=CPU, tail_on_device=True)


def test_device_qrcp_falls_back_to_host_on_complex():
    rng = np.random.default_rng(4)
    M = rng.standard_normal((12, 12)) + 1j * rng.standard_normal((12, 12))
    calls = qrcp_device.calls
    d, h = DeviceQRCP(), QRCP()     # the default device is never asked for
    d.factorize(M)
    h.factorize(M)
    assert qrcp_device.calls == calls
    assert d.rank == h.rank == 12
    for f in ("Q", "R", "jpvt"):
        np.testing.assert_array_equal(getattr(d, f), getattr(h, f))


def test_device_tail_defaults_to_cuda(convdiff_tail):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    A, jo, J, P, b = convdiff_tail
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_factorize(A, JOptions(**dict(OPTS, dense_thres=120,
                                          device_tail=1)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.to_device(tail_on_device=True)


# ---------------------------------------------------------------------------
# the rank rule above the pack's rank


def test_solve_rank_rule():
    assert [solve_rank(r, 6) for r in (None, -1, 0, 1, 6, 7, 8)] == \
        [6, 6, 6, 1, 6, 6, 6]
    q = QRCP()
    q.factorize(_rank6("qrcp"))
    assert q.rank == 6
    assert solve_rank(7, q.rank) == solve_rank(0, q.rank) == 6
    assert solve_rank(3, q.rank) == 3


def _rank6(kind, n=8, seed=0) -> np.ndarray:
    """An 8x8 tail of rank 6 (symmetric for SYEIG)."""
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((n, 6))
    if kind == "syeig":
        return U @ np.diag(rng.uniform(1.0, 2.0, 6)) @ U.T
    return U @ rng.standard_normal((6, n))


@pytest.fixture(scope="module", params=["qrcp", "syeig", "singular40"])
def deficient(request, tmp_path_factory):
    """The 8x8 rank-6 one-level payloads (QRCP and SYEIG), and the singular
    40x40 system factorized by the port (its 12x12 SYEIG tail comes out
    full rank, so there r = rank + 1 lies above nm), with the JAX package's
    host HIF of the same levels as the oracle."""
    if request.param == "singular40":
        A = singular_matrix()
        jo = JOptions(verbose=0, dense_thres=50)
        M = port_factorize(A, jo)
        H = jax_factorize(A, jo)
    else:
        pay, _ = _m0_payload(request.param)
        pay["l0_dense"] = _rank6(request.param)
        path = tmp_path_factory.mktemp(request.param) / "rank6.npz"
        np.savez(path, **pay)
        M = ht.load_prec(str(path))
        H = jload_prec(str(path))
    dp = M.to_device(device=CPU)
    dp.pack_transpose(M.precs)
    rank, nm = dp.tail.rank, dp.tail.Q.shape[0]
    assert rank == H.schur_rank() and 0 < rank <= nm
    assert request.param == "singular40" or rank == 6 < nm
    return M, H, dp, rank, nm


@pytest.mark.parametrize("form", ["single", "mrhs"])
@pytest.mark.parametrize("trans", [False, True])
def test_rank_above_the_pack_keeps_the_pack_rank(deficient, trans, form):
    M, H, dp, rank, nm = deficient
    rng = np.random.default_rng(11)
    B = rng.standard_normal((dp.n, 3))
    for r in (rank + 1, nm):
        if form == "single":
            x = dp.solve(B[:, 0], trans=trans, r=r)
            own = dp.solve(B[:, 0], trans=trans, r=0)
            host = H.solve(B[:, 0], trans=trans, r=r)
        else:
            x = dp.solve_mrhs(B, trans=trans, r=r)
            own = dp.solve_mrhs(B, trans=trans, r=0)
            host = H.solve_mrhs(B, r=r, trans=trans)
        assert bool(torch.isfinite(x).all())
        assert _rel(x, host) <= 1e-10
        assert _rel(x, own) <= 1e-12
