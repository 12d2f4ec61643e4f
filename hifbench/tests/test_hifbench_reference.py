"""The plain reference against the program's own host solves on a small
operator (the tests may import the program; the reference does not)."""

import numpy as np
import pytest

from hifbench import hostprec, problems, reference


@pytest.fixture(scope="module", params=["poisson3d", "convdiff2d"])
def fact(request):
    """A small factorization: a symmetric one (an eigenpair tail) and a
    nonsymmetric one (an LU tail)."""
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.ds.csr import CSR
    from hifir_tpu_torch.models.problems import convdiff2d

    A = (problems.make({"generator": "poisson3d", "nx": 12}) if request.param == "poisson3d"
         else convdiff2d(40).to_scipy().tocsr())
    P = ht.HIF().factorize(CSR.from_scipy(A), ht.Options(verbose=0),
                           device="cpu")
    levels, tail = hostprec.host_levels(P.precs)
    assert tail is not None
    return A, P, levels, tail


def test_msolve_and_mprod_match_the_host(fact):
    A, P, levels, tail = fact
    R = reference.Prec(levels, tail)
    B = np.random.default_rng(1).standard_normal((A.shape[0], 3))
    want = P.solve_mrhs(B)
    for _ in range(2):          # the solve forms are reused in place
        X = reference.msolve(R, B)
        assert np.abs(X - want).max() <= 1e-12 * np.abs(want).max()
    x = B[:, 0]
    y = reference.mprod(R, x)
    assert np.abs(y - P.mmultiply(x)).max() <= 1e-12 * np.abs(y).max()
    assert np.abs(reference.msolve(R, y) - x).max() <= 1e-10


def test_gmres_matches_the_host_driver(fact):
    from hifir_tpu_torch.ds.csr import CSR
    from hifir_tpu_torch.solvers.gmres_np import gmres_hif

    A, P, levels, tail = fact
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    x, steps, conv = reference.gmres(A, reference.Prec(levels, tail), b, 30,
                                     1e-6, 500)
    xh, flag, it = gmres_hif(CSR.from_scipy(A), P, b, restart=30, rtol=1e-6)
    assert conv and flag == 0 and steps == it
    assert np.abs(x - xh).max() <= 1e-10 * np.abs(xh).max()
    x2, steps2, _ = reference.gmres(A, reference.Prec(levels, tail), b, 30,
                                    1e-6, 500, steps=steps - 1)
    assert steps2 == steps - 1


def test_tf32_rounding():
    a = np.array([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                  1 + 2 ** -12, -3.0e-7], np.float32)
    r = reference.round_tf32(a)
    assert r[0] == 1.0 and r[1] == 1 + 2 ** -10
    assert r[2] == 1.0                       # a tie rounds to even
    assert r[3] == 1 + 2 ** -9               # a tie rounds to even
    assert r[4] == 1.0
    bits = r.view(np.uint32) & np.uint32(0x1FFF)
    assert not bits.any()
    assert abs(r[5] + 3.0e-7) <= 3.0e-7 * 2 ** -11
