"""The port's ring Schur SpGEMM and ``Options(dist_schur=1)`` against the
JAX package's, on eight ranks (``make_mesh(8, device="cpu")``; the JAX
conftest's eight virtual CPU devices).

The ring's runs of equal columns are summed in a fixed order that differs
from the JAX kernel's cumulative-sum difference, so values are held to
1e-12 relative (the JAX test's rtol, ``tests/test_parallel.py``); the
patterns, which the masks decide, are equal.  The factorizations load both
native libraries (``jax_lib``, ``tests/test_torch_native.py``), so that
both order with AMD and the factorization of convdiff2d(40) is three levels
deep, as the JAX test requires.
"""

import numpy as np
import pytest

from hifir_tpu.api import HIF as JHIF
from hifir_tpu.ds.csr import csr_from_dense
from hifir_tpu.models import convdiff2d, random_sparse
from hifir_tpu.options import Options as JOptions
from hifir_tpu.parallel import make_mesh as jmake_mesh
from hifir_tpu.parallel.schur import schur_spgemm_ring as jring

import hifir_tpu_torch as ht
from hifir_tpu_torch.parallel import Mesh, make_mesh
from hifir_tpu_torch.parallel.schur import schur_spgemm_ring

from test_torch_native import jax_lib, jax_lib_path  # noqa: F401
from test_torch_parallel import SPLIT
from test_torch_prec import _port

BASE = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5,
            kappa_d=5, verbose=0, dense_thres=20, use_native=0)


@pytest.mark.parametrize("split", [False, True])
def test_schur_spgemm_ring_vs_jax_and_dense_oracle(split):
    """S = C - L_E D U_F on rows and panels not divisible by 8: the port's
    ring equals the dense oracle and the JAX ring (pattern exactly, values
    1e-12)."""
    rng = np.random.default_rng(7)
    m, nm = 90, 53
    L_E = random_sparse(nm, 6, seed=1, ncols=m)
    U_F = random_sparse(m, 5, seed=2, ncols=nm)
    C = random_sparse(nm, 4, seed=3, ncols=nm)
    d = rng.standard_normal(m) + 2.0
    mesh = Mesh(SPLIT) if split else make_mesh(8, device="cpu")
    S = schur_spgemm_ring(_port(C), _port(L_E), d, _port(U_F), mesh=mesh)
    S_dense = C.todense() - L_E.todense() @ np.diag(d) @ U_F.todense()
    np.testing.assert_allclose(S.todense(), S_dense, rtol=1e-12, atol=1e-12)
    J = jring(C, L_E, d, U_F, mesh=jmake_mesh(8))
    np.testing.assert_array_equal(S.indptr, J.indptr)
    np.testing.assert_array_equal(S.indices, J.indices)
    np.testing.assert_allclose(S.data, J.data, rtol=1e-12,
                               atol=1e-12 * np.abs(J.data).max())
    # an empty tail returns C as it is
    E0 = _port(csr_from_dense(np.zeros((0, m))))
    assert schur_spgemm_ring(_port(C), E0, d, _port(U_F),
                             mesh=mesh).nnz == C.nnz


def test_dist_schur_in_multilevel_factorize(jax_lib):  # noqa: F811
    """The JAX test of the same name, on the port: ``dist_schur=1`` runs
    every level's Schur complement as the ring SpGEMM on eight ranks; the
    levels match the host-Schur factorization's (sizes exactly, dense tail
    and solve within 1e-12) and the JAX package's ``dist_schur=1``
    factorization level by level."""
    A = convdiff2d(40)
    P_host = ht.HIF().factorize(_port(A), ht.Options(**BASE), device="cpu")
    P_dist = ht.HIF().factorize(_port(A), ht.Options(dist_schur=1, **BASE),
                                device="cpu")
    J_dist = JHIF().factorize(A, JOptions(dist_schur=1, **BASE))
    assert P_host.levels() == P_dist.levels() == J_dist.levels() >= 3
    b = np.random.default_rng(0).standard_normal(A.nrows)
    for ref in (P_host, J_dist):
        for ph, pd in zip(ref.precs, P_dist.precs):
            assert (ph.m, ph.n) == (pd.m, pd.n)
            if ph.dense_matrix is not None:
                np.testing.assert_allclose(pd.dense_matrix, ph.dense_matrix,
                                           rtol=1e-12, atol=1e-13)
        xh = ref.solve(b)
        np.testing.assert_allclose(P_dist.solve(b), xh, rtol=1e-12,
                                   atol=1e-12 * np.abs(xh).max())
    for pj, pd in zip(J_dist.precs, P_dist.precs):
        for f in ("p", "q"):
            np.testing.assert_array_equal(getattr(pd, f), getattr(pj, f))
        for f in ("L_B", "U_B", "E", "F"):
            np.testing.assert_array_equal(getattr(pd, f).indices,
                                          getattr(pj, f).indices)
