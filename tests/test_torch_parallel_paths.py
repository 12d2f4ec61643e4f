"""The port's ``DistPrec`` on the factorization paths it had not run: the
symmetric (LDL^T), the general nonsymmetric and the pivoting factorization,
each distributed in the halo form (``halo=True``) and the all_gather form
(``halo=False``) on eight CPU ranks.

Both packages factorize with their native libraries (the ``jax_lib``
fixture of ``tests/test_torch_native.py``).  The two factorizations are
equal level by level; the port's DistPrec has the JAX DistPrec's counts,
op kinds, halo plans and exchange plans (``_assert_dist_equal``); its
float64 solve is within 1e-12 of max|x| of the host solve and of the JAX
DistPrec's solve.  A complex
preconditioner stays refused, as the JAX DistPrec is real only.
"""

import numpy as np
import pytest

from hifir_tpu.api import HIF as JHIF
from hifir_tpu.models import convdiff2d, poisson2d
from hifir_tpu.options import PIVOTING_ON as JPIVOTING_ON
from hifir_tpu.options import Options as JOptions
from hifir_tpu.parallel import DistPrec as JDistPrec
from hifir_tpu.parallel import make_mesh as jmake_mesh

import hifir_tpu_torch as ht
import hifir_tpu_torch.pre._native as tnative
from hifir_tpu_torch.options import PIVOTING_ON
from hifir_tpu_torch.parallel import DistPrec, make_mesh

from test_torch_factorize import assert_levels_equal
from test_torch_native import jax_lib, jax_lib_path  # noqa: F401
from test_torch_parallel_prec import RED, _assert_dist_equal, _close_solve
from test_torch_prec import _port

assert PIVOTING_ON == JPIVOTING_ON

# path -> (operator, the options beyond RED)
PATHS = {
    "symmetric": (lambda: poisson2d(64), dict(is_symm=1)),
    "nonsymmetric": (lambda: convdiff2d(64), {}),
    "pivoting": (lambda: convdiff2d(64), dict(pivot=PIVOTING_ON)),
}


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(8, rhs=1)


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(8, device="cpu")


def _pair(path, monkeypatch):
    """Both factorizations, counting the port's pivoting Crout calls."""
    make, extra = PATHS[path]
    A = make()
    o = dict(RED, **extra)
    J = JHIF().factorize(A, JOptions(**o))
    calls = []
    pivot = tnative.crout_pivot
    monkeypatch.setattr(tnative, "crout_pivot",
                        lambda *a, **k: calls.append(1) or pivot(*a, **k))
    P = ht.HIF().factorize(_port(A), ht.Options(**o), device="cpu")
    return A, J, P, len(calls)


@pytest.mark.parametrize("halo", [True, False], ids=["halo", "all_gather"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_dist_prec_path_matches_jax(path, halo, jax_lib,  # noqa: F811
                                    jmesh, tmesh, monkeypatch):
    A, J, P, pivot_calls = _pair(path, monkeypatch)
    assert_levels_equal(P, J)
    assert P.levels() >= 2
    # the pivoting path runs the rook-pivoting Crout on every level
    assert pivot_calls == (len(P.precs) if path == "pivoting" else 0)
    if path == "symmetric":
        # the LDL^T path packs U_B = L_B^T
        for p in P.precs:
            np.testing.assert_array_equal(p.U_B.todense(),
                                          p.L_B.todense().T)
    dp = DistPrec.from_host(tmesh, P, chunk=64, halo=halo)
    jdp = JDistPrec.from_host(jmesh, J, chunk=64, halo=halo)
    _assert_dist_equal(dp, jdp, tmesh)
    if halo:
        assert dp.n_halo > 0 and dp.comm_elems < dp.allgather_elems
    else:
        assert dp.n_halo == 0
    b = np.random.default_rng(7).standard_normal(A.nrows)
    x = dp.solve(b)
    _close_solve(x, P.solve(b))
    _close_solve(x, np.asarray(jdp.solve(b)))


def test_dist_prec_refuses_complex(tmesh):
    """A complex M raises TypeError naming the cause, in both forms."""
    A = convdiff2d(16)
    P = ht.HIF().factorize(_port(A), ht.Options(**dict(RED, dense_thres=30)),
                           device="cpu")
    for p in P.precs:
        p.d = p.d.astype(np.complex128)
    for halo in (True, False):
        with pytest.raises(TypeError, match="complex"):
            DistPrec.from_host(tmesh, P, chunk=32, halo=halo)
