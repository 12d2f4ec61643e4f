"""The port's ``DistPrec`` against the JAX package's, on eight ranks.

Both packages factorize with their native libraries (the JAX library built
into ``build/hifir_tpu/native/`` and loaded through ``HIFIR_TPU_LIB``, the
``jax_lib`` fixture of ``tests/test_torch_native.py``; the port's own
library on), so that the factorization of poisson2d(64) under the JAX
distribution tests' options has the three levels their halo and exchange
paths exist for.  The two factorizations are equal level by level; the
port's DistPrec then has the JAX DistPrec's halo plans, exchange plans and
host-counted volumes, and solves within 1e-12 max|x| of the host solve in
every form the JAX tests use (``tests/test_parallel.py``).
"""

import numpy as np
import pytest
import torch

from hifir_tpu.api import HIF as JHIF
from hifir_tpu.models import convdiff2d, poisson2d
from hifir_tpu.options import Options as JOptions
from hifir_tpu.parallel import DistPrec as JDistPrec
from hifir_tpu.parallel import make_mesh as jmake_mesh
from hifir_tpu.parallel.trsv_halo import HaloOp as JHaloOp

import hifir_tpu_torch as ht
from hifir_tpu_torch.parallel import DistPrec, Mesh, make_mesh
from hifir_tpu_torch.parallel.prec_sharded import AGTrsvOp
from hifir_tpu_torch.parallel.trsv_halo import HaloOp

from test_torch_factorize import assert_levels_equal
from test_torch_native import jax_lib, jax_lib_path  # noqa: F401
from test_torch_parallel import SPLIT, _assert_halo_plans_equal, _np
from test_torch_prec import _port

RED = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5, kappa_d=5,
           verbose=0, dense_thres=50)


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(8, rhs=1)


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(8, device="cpu")


@pytest.fixture
def pair(jax_lib):  # noqa: F811
    """poisson2d(64) factorized by both packages with their libraries."""
    A = poisson2d(64)
    J = JHIF().factorize(A, JOptions(**RED))
    P = ht.HIF().factorize(_port(A), ht.Options(**RED), device="cpu")
    return A, J, P


def _close_solve(x, xh):
    np.testing.assert_allclose(_np(x), xh, rtol=0,
                               atol=1e-12 * np.abs(xh).max())


def _assert_dist_equal(dp, jdp, mesh):
    """Counts, op kinds, halo plans and exchange plans equal the JAX
    DistPrec's."""
    assert (dp.comm_elems, dp.allgather_elems, dp.n_halo) == (
        jdp.comm_elems, jdp.allgather_elems, jdp.n_halo)
    for lv, jl in zip(dp.levels, jdp.levels):
        assert (lv.m, lv.n, lv.E_rows, lv.F_rows) == (jl.m, jl.n, jl.E_rows,
                                                     jl.F_rows)
        for op, jop in ((lv.L_op, jl.L_op), (lv.U_op, jl.U_op)):
            assert isinstance(op, HaloOp) == isinstance(jop, JHaloOp)
            if isinstance(op, HaloOp):
                _assert_halo_plans_equal(op, jop, mesh)
            else:
                assert (op.nchunks, op.chunk, op.n, op.sharded) == (
                    jop.nchunks, jop.chunk, jop.n, jop.sharded)
        assert (lv.xin is None) == (jl.xin is None)
        if lv.xin is not None:
            assert lv.xin.meta == jl.xin.meta
            assert (lv.xin.comm_elems, lv.xin.allgather_elems) == (
                jl.xin.comm_elems, jl.xin.allgather_elems)
            for s, js in zip(lv.xin.sends, jl.xin.sends):
                np.testing.assert_array_equal(_np(mesh.collect(s)),
                                              np.asarray(js))
            np.testing.assert_array_equal(_np(mesh.collect(lv.xin.fetch)),
                                          np.asarray(jl.xin.fetch))


def test_dist_prec_halo_exact_and_comm_reduction(pair, jmesh, tmesh):
    """The JAX test of the same name, on the port: >= 3 levels, every
    non-trivial factor halo-carried with >= 8 chunks on the first two
    levels, the exchange volume below half the tiled all_gather's, the
    solve within 1e-12 max|x| of the host solve; the all_gather form
    (``halo=False``) as exact.  Plans and counts equal the JAX DistPrec's."""
    A, J, P = pair
    assert_levels_equal(P, J)
    assert P.levels() >= 3
    dp = DistPrec.from_host(tmesh, P, chunk=64)
    _assert_dist_equal(dp, JDistPrec.from_host(jmesh, J, chunk=64), tmesh)
    assert dp.n_halo >= 4
    assert all(isinstance(lv.L_op, HaloOp) and lv.L_op.nchunks >= 8
               for lv in dp.levels[:2])
    assert dp.comm_elems < 0.5 * dp.allgather_elems
    b = np.random.default_rng(0).standard_normal(A.nrows)
    xh = P.solve(b)
    _close_solve(dp.solve(b), xh)
    dp_ag = DistPrec.from_host(tmesh, P, chunk=64, halo=False)
    assert dp_ag.n_halo == 0
    assert all(isinstance(lv.L_op, AGTrsvOp) for lv in dp_ag.levels)
    _close_solve(dp_ag.solve(b), xh)


def test_dist_prec_ef_exchange_link(pair, jmesh, tmesh):
    """The JAX test of the same name, on the port: every level after the
    first fetches its input through an exchange plan cheaper than
    replicating the producer vector; exact; without sharded vectors no plan
    and as exact.  The unsharded form's counts equal the JAX DistPrec's."""
    A, J, P = pair
    dp = DistPrec.from_host(tmesh, P, chunk=64)
    assert all(lv.xin is not None for lv in dp.levels[1:])
    for lv in dp.levels[1:]:
        assert lv.xin.comm_elems < lv.xin.allgather_elems
    b = np.random.default_rng(3).standard_normal(A.nrows)
    xh = P.solve(b)
    _close_solve(dp.solve(b), xh)
    dp0 = DistPrec.from_host(tmesh, P, chunk=64, shard_vectors=False)
    _assert_dist_equal(dp0, JDistPrec.from_host(jmesh, J, chunk=64,
                                                shard_vectors=False), tmesh)
    assert all(lv.xin is None for lv in dp0.levels)
    _close_solve(dp0.solve(b), xh)


def test_dist_prec_split_groups_and_f32(pair):
    """The same DistPrec on two groups of four ranks (the collectives'
    cross-group copies) is as exact; float32 within 1e-4 max|x|."""
    A, _, P = pair
    b = np.random.default_rng(5).standard_normal(A.nrows)
    xh = P.solve(b)
    _close_solve(DistPrec.from_host(Mesh(SPLIT), P, chunk=64).solve(b), xh)
    x32 = DistPrec.from_host(make_mesh(8, device="cpu"), P, chunk=64,
                             dtype=np.float32).solve(b)
    assert x32.dtype == torch.float32
    np.testing.assert_allclose(_np(x32), xh, rtol=0,
                               atol=1e-4 * np.abs(xh).max())


def test_distributed_prec_solve_matches_jax(jmesh, tmesh):
    """``test_distributed_prec_solve`` on both packages (numpy anchors,
    equal levels): the port's solve equals the JAX DistPrec's and the host
    solve within 1e-12 max|x|; a complex preconditioner is refused."""
    from test_torch_factorize import jax_factorize, port_factorize

    A = convdiff2d(16)
    jo = JOptions(**dict(RED, dense_thres=30))
    J, P = jax_factorize(A, jo), port_factorize(A, jo)
    jdp = JDistPrec.from_host(jmesh, J, chunk=32)
    dp = DistPrec.from_host(tmesh, P, chunk=32)
    _assert_dist_equal(dp, jdp, tmesh)
    b = np.random.default_rng(0).standard_normal(A.nrows)
    xh = P.solve(b)
    x = dp.solve(b)
    _close_solve(x, xh)
    _close_solve(x, np.asarray(jdp.solve(b)))
    per = dp.nbytes_per_rank()
    assert per["sharded"] > 0 and per["vectors"] > 0
    # chunk="auto": the cost model's chunk a factor, a multiple of the
    # rank count, as the JAX package chooses it
    dpa = DistPrec.from_host(tmesh, P, chunk="auto", halo=False)
    jpa = JDistPrec.from_host(jmesh, J, chunk="auto", halo=False)
    _assert_dist_equal(dpa, jpa, tmesh)
    assert all(op.chunk % 8 == 0 for lv in dpa.levels
               for op in (lv.L_op, lv.U_op))
    _close_solve(dpa.solve(b), xh)
    Pc = port_factorize(A, jo)
    for p in Pc.precs:
        p.d = p.d.astype(np.complex128)
    with pytest.raises(TypeError, match="complex"):
        DistPrec.from_host(tmesh, Pc, chunk=32)
