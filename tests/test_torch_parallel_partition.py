"""The port's ``PartitionedHIF`` against the JAX package's.

Both packages band with their native libraries' RCM (``jax_lib``,
``tests/test_torch_native.py``) and factorize every part with them, so the
parts, overlaps and local factorizations agree; the RAS apply, its adjoint
and its multi-RHS form then agree within 1e-12.  The device forms
(``to_device``: a DevicePrec a part; ``attach_dist_solvers``: a DistPrec a
part on eight ranks) equal the host apply within 1e-12 max|x|; the adjoint
keeps the host path, as in the JAX package.
"""

import numpy as np
import pytest

from hifir_tpu.models import poisson2d
from hifir_tpu.options import Options as JOptions
from hifir_tpu.parallel.partition import PartitionedHIF as JPartitionedHIF

import hifir_tpu_torch as ht
from hifir_tpu_torch.parallel import PartitionedHIF, make_mesh
from hifir_tpu_torch.solvers.gmres_np import gmres_hif

from test_torch_native import jax_lib, jax_lib_path  # noqa: F401
from test_torch_prec import _port

OPTS = dict(verbose=0, tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3,
            kappa=5, kappa_d=5, dense_thres=200)


def _close(x, ref, tol=1e-12):
    np.testing.assert_allclose(x, ref, rtol=0, atol=tol * np.abs(ref).max())


def test_partitioned_hif_exact_single_part():
    """nparts=1 reduces exactly to the global HIF."""
    A = _port(poisson2d(32))
    o = ht.Options(verbose=0)
    b = np.ones(A.nrows)
    P = PartitionedHIF().factorize(A, 1, o)
    M = ht.HIF().factorize(A, o, device="cpu")
    np.testing.assert_array_equal(P.solve(b), M.solve(b))


def test_partitioned_matches_jax(jax_lib):  # noqa: F811
    """Four parts of poisson2d(24) with overlap 12: the banding, the parts
    and the apply (forward, adjoint, three RHS) equal the JAX package's."""
    A = poisson2d(24)
    J = JPartitionedHIF().factorize(A, 4, JOptions(verbose=0), overlap=12)
    P = PartitionedHIF().factorize(_port(A), 4, ht.Options(verbose=0),
                                   overlap=12)
    np.testing.assert_array_equal(P.perm, J.perm)
    assert [(p.lo, p.hi, p.lo_ext, p.hi_ext) for p in P.parts] == [
        (p.lo, p.hi, p.lo_ext, p.hi_ext) for p in J.parts]
    assert (P.levels(), P.nnz()) == (J.levels(), J.nnz())
    rng = np.random.default_rng(0)
    B = rng.standard_normal((A.nrows, 3))
    _close(P.solve(B[:, 0]), J.solve(B[:, 0]))
    _close(P.solve(B[:, 1], trans=True), J.solve(B[:, 1], trans=True))
    X = P.solve_mrhs(B)
    _close(X, J.solve_mrhs(B))
    for j in range(3):
        _close(X[:, j], P.solve(B[:, j]))


def test_partitioned_device_forms(jax_lib):  # noqa: F811
    """``to_device`` and ``attach_dist_solvers`` on eight CPU ranks against
    the host RAS apply (1e-12 max|x|); the adjoint keeps the host path; the
    distributed form equals the JAX package's host apply too."""
    A = poisson2d(32)
    P = PartitionedHIF().factorize(_port(A), 4, ht.Options(**OPTS))
    J = JPartitionedHIF().factorize(A, 4, JOptions(**OPTS))
    b = np.random.default_rng(1).standard_normal(A.nrows)
    xh = P.solve(b)
    _close(P.to_device(device="cpu").solve(b), xh)
    xt = P.solve(b, trans=True)
    P.attach_dist_solvers(make_mesh(8, device="cpu"), chunk=64)
    assert all(p.M_dist is not None for p in P.parts)
    _close(P.local_contrib(b), xh)
    _close(P.local_contrib(b), J.solve(b))
    np.testing.assert_array_equal(P.local_contrib(b, trans=True), xt)


@pytest.mark.parametrize("mode,q", [("cheb", 1), ("geneo", 3)])
def test_coarse_modes_converge(mode, q):
    """The coarse spaces of ``test_parallel.py::test_geneo_coarse_space``:
    GMRES with the RAS preconditioner of poisson2d(64) in four parts
    converges to 1e-6 in each mode (the true residual checked), and GenEO
    needs at most two iterations more than the polynomial default."""
    A = _port(poisson2d(64))
    b = A.matvec(np.ones(A.nrows))
    its = {}
    for md, qq in {(mode, q), ("cheb", 1)}:
        P = PartitionedHIF().factorize(A, 4, ht.Options(**OPTS),
                                       coarse_mode=md, coarse_dim=qq)
        x, flag, its[md] = gmres_hif(A, P, b, restart=30, rtol=1e-6,
                                     maxit=400)
        assert flag == 0, md
        assert np.linalg.norm(b - A.matvec(x)) <= 1.01e-6 * np.linalg.norm(b)
    assert its[mode] <= its["cheb"] + 2, its


def test_partition_guards():
    A = _port(poisson2d(8))
    with pytest.raises(ValueError, match="nparts"):
        PartitionedHIF().factorize(A, 0)
    with pytest.raises(ValueError, match="together"):
        PartitionedHIF().factorize(A, 2, process_rank=0)
    P = PartitionedHIF().factorize(A, 2, ht.Options(verbose=0),
                                   process_rank=0, process_count=2)
    assert [p.M is None for p in P.parts] == [False, True]
    with pytest.raises(RuntimeError, match="local_contrib"):
        P.solve(np.ones(A.nrows))
