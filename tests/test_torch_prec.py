"""The port's whole slice against the JAX package and the host solve.

Factors come from the JAX package's ``HIF`` (or its frozen fixture) and are
carried across with ``save_prec`` -> ``prec_from_arrays``, so both packages
apply the same preconditioner.  f64 results must agree within 1e-10 relative
to max|X| (the tolerance of ``tests/test_device.py``); f32 results within
1e-4 of the host f64 solve (``bench.py``'s gate).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hifir_tpu.alg.prec import DevicePrec as JDevicePrec
from hifir_tpu.api import HIF as JHIF
from hifir_tpu.models import convdiff2d, saddle_point_stokes
from hifir_tpu.ops.pallas_spmv import bsr_from_csr as jbsr_from_csr
from hifir_tpu.ops.spmv import sliced_ell_from_csr as jsliced_ell_from_csr
from hifir_tpu.options import Options
from hifir_tpu.solvers.gmres import ir_apply_device
from hifir_tpu.utils.serialize import load_prec as jload_prec
from hifir_tpu.utils.serialize import save_prec

import hifir_tpu_torch as ht
from hifir_tpu_torch.alg.prec import DevicePrec
from hifir_tpu_torch.ds.csr import CSR
from hifir_tpu_torch.ops.bsr_spmv import bsr_from_csr
from hifir_tpu_torch.ops.spmv import sliced_ell_from_csr
from hifir_tpu_torch.ops.trsv import TrsvSchedule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "benchdata", "frozen_prec.npz")
CPU = "cpu"


def _values(X) -> np.ndarray:
    """A tensor's (a lazy conjugate view's resolved) or an array's values."""
    return X.resolve_conj().numpy() if torch.is_tensor(X) else np.asarray(X)


def _rel(X, Xref):
    """max |X - Xref| / max |Xref|, the magnitude of the complex difference
    for complex values, computed in float64 or complex128 (never casting a
    complex value to a real one)."""
    X, Xref = _values(X), _values(Xref)
    dt = np.result_type(X.dtype, Xref.dtype, np.float64)
    X, Xref = X.astype(dt), Xref.astype(dt)
    return np.abs(X - Xref).max() / np.abs(Xref).max()


def _port(A) -> CSR:
    return CSR(A.nrows, A.ncols, A.indptr, A.indices, A.data)


def _carry(M, tmp_path):
    """The JAX HIF's levels as a ``save_prec`` payload, rebuilt by the port."""
    path = tmp_path / "prec.npz"
    save_prec(str(path), M)
    with np.load(path) as z:
        return ht.prec_from_arrays(dict(z))


_PROBLEMS = {"convdiff16": lambda: convdiff2d(16),
             "stokes8": lambda: saddle_point_stokes(8)}


@pytest.fixture(scope="module", params=sorted(_PROBLEMS))
def factored(request, tmp_path_factory):
    A = _PROBLEMS[request.param]()
    opts = Options(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5,
                   kappa_d=5, verbose=0, dense_thres=30)
    M = JHIF().factorize(A, opts)
    precs = _carry(M, tmp_path_factory.mktemp(request.param))
    B = np.random.default_rng(1).standard_normal((A.nrows, 5))
    return A, M, precs, B, M.solve_mrhs(B)


@pytest.mark.parametrize("dense_inv", [0, 16, 32, "auto"])
def test_solve_mrhs_f64_matches_jax_and_host(factored, dense_inv):
    A, M, precs, B, Xhost = factored
    X = DevicePrec.from_host(precs, dense_inv=dense_inv,
                             device=CPU).solve_mrhs(B)
    jdp = JDevicePrec.from_host(M.precs, dense_inv=dense_inv)
    Xj = jdp.solve_mrhs(jnp.asarray(B))
    assert _rel(X, Xj) <= 1e-10
    assert _rel(X, Xhost) <= 1e-10


@pytest.mark.parametrize("dense_inv", [0, "auto"])
def test_solve_f32_within_bench_gate(factored, dense_inv):
    A, M, precs, B, Xhost = factored
    dp = DevicePrec.from_host(precs, dtype=np.float32, dense_inv=dense_inv,
                              device=CPU)
    X = dp.solve_mrhs(B)
    assert X.dtype == torch.float32
    assert _rel(X, Xhost) <= 1e-4
    # single-RHS solve is the one-column batched solve
    assert _rel(dp.solve(B[:, 0]), Xhost[:, 0]) <= 1e-4


def test_frozen_fixture_loads_like_reference():
    M = ht.load_prec(FIXTURE)
    J = jload_prec(FIXTURE)
    assert len(M.precs) == len(J.precs) and M.nnz() == J.nnz()
    for p, jp in zip(M.precs, J.precs):
        assert (p.m, p.n) == (jp.m, jp.n)
        for f in ("d", "s", "t", "p", "p_inv", "q", "q_inv"):
            np.testing.assert_array_equal(getattr(p, f), getattr(jp, f))
        for f in ("L_B", "U_B", "E", "F"):
            a, b = getattr(p, f), getattr(jp, f)
            assert a.shape == b.shape
            for g in ("indptr", "indices", "data"):
                np.testing.assert_array_equal(getattr(a, g), getattr(b, g))
    ds, jds = M.precs[-1].dense_solver, J.precs[-1].dense_solver
    assert (ds.kind, ds.rank) == (jds.kind, jds.rank) == ("qrcp", 360)
    for f in ("Q", "R", "jpvt"):
        np.testing.assert_array_equal(getattr(ds, f), getattr(jds, f))


def test_frozen_fixture_solve_matches_jax():
    """One f64 solve of 4 RHS through the level scan (dense_inv=0), the
    form that the fixture's explicit-inverse default skips."""
    B = np.random.default_rng(2).standard_normal((16384, 4))
    X = ht.load_prec(FIXTURE).to_device(device=CPU, dense_inv=0).solve_mrhs(B)
    jdp = JDevicePrec.from_host(jload_prec(FIXTURE).precs, dense_inv=0)
    assert _rel(X, jdp.solve_mrhs(jnp.asarray(B))) <= 1e-10


@pytest.mark.parametrize("op", ["bsr", "sliced_ell"])
def test_hifir_ir_apply_matches_jax(tmp_path, op):
    A = convdiff2d(16)
    opts = Options(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5,
                   kappa_d=5, verbose=0, dense_thres=30)
    M = JHIF().factorize(A, opts)
    dp = DevicePrec.from_host(_carry(M, tmp_path), dense_inv=0, device=CPU)
    jdp = JDevicePrec.from_host(M.precs, dense_inv=0)
    if op == "bsr":
        At = bsr_from_csr(_port(A), bs=64, device=CPU)
        Aj = jbsr_from_csr(A, bs=64)
    else:
        At = sliced_ell_from_csr(_port(A), device=CPU)
        Aj = jsliced_ell_from_csr(A)
    b = np.random.default_rng(3).standard_normal(A.nrows)
    x = ht.ir_apply(At, dp, b, nirs=3)
    xj = ir_apply_device(Aj, jdp.levels, jdp.tail, jnp.asarray(b), 3)
    assert x.shape == (A.nrows,)
    assert _rel(x, xj) <= 1e-10
    # refinement reduced the residual below the plain M-solve's
    r1 = np.linalg.norm(b - A.matvec(dp.solve(b).numpy()))
    r3 = np.linalg.norm(b - A.matvec(x.numpy()))
    assert r3 < r1


def _m0_payload(kind, n=8, seed=0):
    """A one-level preconditioner with m == 0: everything is the dense tail."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((n, n)) + n * np.eye(n)
    if kind == "syeig":
        D = D + D.T
    empty = dict(indptr=np.zeros(1, np.int64), indices=np.empty(0, np.int32),
                 data=np.empty(0))
    pay = {"nlevels": np.int64(1), "stats": np.zeros(1),
           "l0_mn": np.array([0, n]), "l0_dense": D,
           "l0_dense_kind": np.array(kind)}
    for f, shape in (("L_B", (0, 0)), ("U_B", (0, 0)), ("E", (n, 0)),
                     ("F", (0, n))):
        pay.update({f"l0_{f}_{k}": v for k, v in empty.items()})
        pay[f"l0_{f}_indptr"] = np.zeros(shape[0] + 1, np.int64)
        pay[f"l0_{f}_shape"] = np.array(shape)
    pay.update(l0_d=np.empty(0), l0_s=np.ones(n), l0_t=np.ones(n),
               l0_p=np.arange(n), l0_p_inv=np.arange(n), l0_q=np.arange(n),
               l0_q_inv=np.arange(n))
    return pay, D


@pytest.mark.parametrize("kind", ["qrcp", "syeig", "lup"])
def test_m0_level_packs_empty_schedule(tmp_path, kind):
    """The JAX package packs a 2048^2 identity for an m == 0 level; the port
    packs an empty schedule.  Results, not layouts, must agree."""
    pay, D = _m0_payload(kind)
    path = tmp_path / "m0.npz"
    np.savez(path, **pay)
    dp = ht.load_prec(str(path)).to_device(device=CPU)
    lvl = dp.levels[0]
    assert isinstance(lvl.L, TrsvSchedule) and lvl.L.nchunks == 0
    assert isinstance(lvl.U, TrsvSchedule) and lvl.U.nchunks == 0
    B = np.random.default_rng(5).standard_normal((8, 3))
    X = dp.solve_mrhs(B)
    assert _rel(X, np.linalg.solve(D, B)) <= 1e-10
    jdp = jload_prec(str(path)).to_device()
    assert _rel(X, jdp.solve_mrhs(jnp.asarray(B))) <= 1e-10


def test_port_imports_no_jax():
    code = (
        "import sys, numpy as np\n"
        "import hifir_tpu_torch as ht\n"
        f"M = ht.load_prec({FIXTURE!r})\n"
        "dp = M.to_device(device='cpu', dense_inv=0)\n"
        "x = dp.solve(np.ones(dp.n))\n"
        "assert bool(x.isfinite().all())\n"
        "dp.pack_transpose(M.precs)\n"
        "assert bool(dp.solve(x, trans=True, r=300).isfinite().all())\n"
        "dp.pack_prod(M.precs)\n"
        "assert bool(dp.mmultiply(x).isfinite().all())\n"
        "from hifir_tpu_torch.models.problems import poisson2d\n"
        "from hifir_tpu_torch.ops.spmv import sliced_ell_from_csr\n"
        "A = sliced_ell_from_csr(poisson2d(128), device='cpu')\n"
        "x, flag, it = ht.gmres_hif(A, dp, np.ones(dp.n), restart=2,"
        " maxit=2)\n"
        "assert it == 2 and bool(x.isfinite().all())\n"
        "from hifir_tpu_torch.models.problems import convdiff2d\n"
        "H = ht.HIF().factorize(convdiff2d(16), ht.Options(verbose=0,"
        " dense_thres=30, device_tail=1), device='cpu')\n"
        "assert H.precs[-1].dense_solver.kind == 'qrcp'\n"
        "dq = H.to_device(device='cpu', tail_on_device=True)\n"
        "assert bool(dq.solve(np.ones(dq.n)).isfinite().all())\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m == 'hifir_tpu'"
        " or m.startswith('hifir_tpu.')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    pay, _ = _m0_payload("qrcp")
    precs = ht.prec_from_arrays(pay)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DevicePrec.from_host(precs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ht.HIF(precs).to_device()
    assert DevicePrec.from_host(precs, device=CPU).device.type == "cpu"
