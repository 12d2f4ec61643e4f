"""The port's distribution (``hifir_tpu_torch/parallel``) against the JAX
package's, on eight ranks: the JAX conftest's eight virtual CPU devices and
the port's ``make_mesh(8, device="cpu")``.

Here: the mesh's collectives (one group and split into two groups), the
sharded and halo SpMV, the IR step, the distributed trsv in both forms
(their plans equal to the JAX plans), the exchange plans, and K10a's and
K10b's plain versions against the JAX ``shard_map`` bodies they replace.
Inputs come from numpy seeds; tolerances are the JAX tests' (1e-12 for the
SpMV, 1e-10 for the trsv, ``tests/test_parallel.py``).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as JP

from hifir_tpu.models import (convdiff2d, poisson2d, random_sparse,
                              random_strict_triangular)
from hifir_tpu.options import Options as JOptions
from hifir_tpu.parallel import make_mesh as jmake_mesh
import hifir_tpu.parallel as jpar
from hifir_tpu.parallel import exchange as jexchange
from hifir_tpu.parallel import schur as jschur

from hifir_tpu_torch import parallel as tpar
from hifir_tpu_torch.ops import chunk as tchunk
from hifir_tpu_torch.parallel import Mesh, make_mesh
from hifir_tpu_torch.parallel import schur as tschur

from test_torch_factorize import jax_factorize, port_factorize
from test_torch_prec import _port

CPU = torch.device("cpu")
# two groups of four ranks: "cpu" and "cpu:0" are distinct devices that
# both compute on the CPU, so the collectives' cross-group copies run
SPLIT = [CPU] * 4 + [torch.device("cpu", 0)] * 4


@pytest.fixture(scope="module")
def jmesh_rows():
    return jmake_mesh(8, rhs=1)


@pytest.fixture(params=["one", "split"])
def tmesh(request):
    return (make_mesh(8, device="cpu") if request.param == "one"
            else Mesh(SPLIT))


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# the mesh

def test_mesh_layout():
    m = make_mesh(8, rhs=2, device="cpu")
    assert m.shape == {"rhs": 2, "rows": 4}
    assert [(g.lo, g.hi) for g in m.groups()] == [(0, 4)]
    assert [(g.lo, g.hi) for g in Mesh(SPLIT).groups()] == [(0, 4), (4, 8)]
    with pytest.raises(ValueError, match="rhs=3"):
        make_mesh(8, rhs=3, device="cpu")


@pytest.mark.parametrize("step,ring", [(1, False), (-1, False), (-1, True),
                                       (1, True)])
def test_mesh_shift_is_ppermute(tmesh, step, ring):
    """``shift`` equals ``jax.lax.ppermute`` with the JAX package's
    permutations (edge ranks receive zeros unless ``ring``)."""
    a = np.random.default_rng(0).standard_normal((8, 5))
    got = tmesh.collect(tmesh.shift(tmesh.put(a), step, ring=ring))
    want = np.zeros_like(a)
    for k in range(8):
        src = k - step
        if ring:
            src %= 8
        if 0 <= src < 8:
            want[k] = a[src]
    np.testing.assert_array_equal(_np(got), want)


def test_mesh_all_gather_psum(tmesh):
    a = np.random.default_rng(1).standard_normal((8, 3, 2))
    got = _np(tmesh.collect(tmesh.all_gather(tmesh.put(a))))
    for k in range(8):
        np.testing.assert_array_equal(got[k], a.reshape(24, 2))
    s = _np(tmesh.collect(tmesh.psum(tmesh.put(a))))
    np.testing.assert_allclose(s, np.broadcast_to(a.sum(0), a.shape),
                               rtol=1e-15)
    assert _np(torch.cat(tmesh.axis_index())).tolist() == list(range(8))


# ---------------------------------------------------------------------------
# K10a and K10b, plain versions

def test_chunk_fma_plain_formula():
    """K10a's plain version computes ``x[r, off + r*step + j] -=
    sum_k vals * x[r, cols]`` for every rank, in both layouts."""
    rng = np.random.default_rng(2)
    R, L, cloc, K = 3, 40, 4, 3
    x0 = rng.standard_normal((R, L))
    cols = rng.integers(0, 12, (R, cloc, K)).astype(np.int32)
    vals = rng.standard_normal((R, cloc, K))
    for off, step in ((20, 0), (16, cloc)):
        want = x0.copy()
        for r in range(R):
            for j in range(cloc):
                want[r, off + r * step + j] -= vals[r, j] @ x0[r, cols[r, j]]
        x = torch.tensor(x0)
        tchunk.ChunkSweep(x)(torch.tensor(cols), torch.tensor(vals), off,
                             step)
        np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=1e-14)
    with pytest.raises(ValueError, match="outside"):
        tchunk.ChunkSweep(torch.tensor(x0))(torch.tensor(cols),
                                            torch.tensor(vals), L - 2)


def test_schur_partial_plain_matches_jax_body(jmesh_rows):
    """K10b's plain version against the JAX ring step's ``shard_map`` body
    (``schur.py:_partial_kernel``) on the same packed inputs: columns and
    masks equal, values within 1e-12 (the JAX test's rtol)."""
    rng = np.random.default_rng(7)
    m, nm, D = 90, 53, 8
    L_E = random_sparse(nm, 6, seed=1, ncols=m)
    U_F = random_sparse(m, 5, seed=2, ncols=nm)
    d = rng.standard_normal(m) + 2.0
    nmp = -(-nm // D) * D
    nb = cb = nmp // D
    le_i, le_v, KL = jschur._ell_pack(L_E, nmp, sentinel=m)
    uf_i, uf_v, KU = jschur._panelize_uf(U_F, D, cb)
    d_ext = np.concatenate([d, [0.0]])
    sh3 = NamedSharding(jmesh_rows, JP("rows", None, None))
    step = jax.jit(jax.shard_map(
        functools.partial(jschur._partial_kernel, cb=cb, axis="rows"),
        mesh=jmesh_rows,
        in_specs=(JP("rows", None, None), JP("rows", None, None), JP(),
                  JP("rows", None, None), JP("rows", None, None)),
        out_specs=(JP("rows", None, None), JP("rows", None, None)),
        check_vma=False))
    jc, jv = step(jax.device_put(le_i.reshape(D, nb, KL), sh3),
                  jax.device_put(le_v.reshape(D, nb, KL), sh3),
                  jnp.asarray(d_ext), jax.device_put(uf_i, sh3),
                  jax.device_put(uf_v, sh3))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    tc, tv = tschur.schur_partial_plain(
        t(le_i.reshape(D, nb, KL)), t(le_v.reshape(D, nb, KL)),
        t(np.broadcast_to(d_ext, (D, m + 1))), t(uf_i), t(uf_v), cb)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    jv = np.asarray(jv)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-12,
                               atol=1e-12 * np.abs(jv).max())


# ---------------------------------------------------------------------------
# sharded and halo SpMV, the IR step

def test_sharded_spmv_matches_jax():
    A = convdiff2d(12)
    jm = jmake_mesh(8, rhs=2)
    x = np.random.default_rng(0).standard_normal(A.nrows)
    jy = np.asarray(jpar.sharded_spmv(jm, jpar.shard_ell_rows(jm, A),
                                      jnp.asarray(x)))
    for tm in (make_mesh(8, rhs=2, device="cpu"), Mesh(SPLIT, rhs=2)):
        Ae = tpar.shard_ell_rows(tm, _port(A))
        ty = tpar.sharded_spmv(tm, Ae, torch.tensor(x)).numpy()
        assert ty.shape == jy.shape
        np.testing.assert_allclose(ty, jy, rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(ty[:A.nrows], A.matvec(x), rtol=1e-12)


def test_halo_spmv_matches_jax(jmesh_rows, tmesh):
    A = poisson2d(16)
    JH = jpar.build_halo_spmv(jmesh_rows, A)
    H = tpar.build_halo_spmv(tmesh, _port(A))
    assert (H.nb, H.halo, H.n) == (JH.nb, JH.halo, JH.n)
    np.testing.assert_array_equal(_np(tmesh.collect(H.idx)),
                                  np.asarray(JH.idx))
    x = np.random.default_rng(0).standard_normal(H.nb * 8)
    x[A.nrows:] = 0.0
    xs = jax.device_put(jnp.asarray(x),
                        NamedSharding(jmesh_rows, JP("rows")))
    jy = np.asarray(jpar.halo_spmv(JH, xs))
    ty = tpar.halo_spmv(H, torch.tensor(x)).numpy()
    np.testing.assert_allclose(ty, jy, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(ty[:A.nrows], A.matvec(x[:A.nrows]),
                               rtol=1e-12)
    with pytest.raises(ValueError, match="halo"):
        tpar.build_halo_spmv(tmesh, _port(random_sparse(1024, 6, seed=1)))


def test_sharded_ir_step_matches_jax():
    """Thirty IR steps on a (2, 4) mesh: the port's X equals the JAX
    step's X at every step (1e-12 of max|X|) and the residual falls to
    the JAX test's 1e-10."""
    A = poisson2d(10)
    n = A.nrows
    opts = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5,
                kappa_d=5, verbose=0, dense_thres=30)
    # both factorizations on their numpy anchors: equal levels
    JM = jax_factorize(A, JOptions(**opts))
    jm = jmake_mesh(8, rhs=2)
    JAe = jpar.shard_ell_rows(jm, A)
    jlev, jtail = JM.to_device().operands()
    jstep = jpar.make_sharded_ir_step(jm, n)
    dp = port_factorize(A, JOptions(**opts)).to_device(device="cpu")
    tm = make_mesh(8, rhs=2, device="cpu")
    Ae = tpar.shard_ell_rows(tm, _port(A))
    step = tpar.make_sharded_ir_step(tm, n)
    npad = Ae.nrows
    assert npad == JAe.nrows
    B = np.random.default_rng(1).standard_normal((n, 4))
    Bp = np.concatenate([B, np.zeros((npad - n, 4))])
    JX = jnp.zeros((npad, 4))
    X = torch.zeros((npad, 4), dtype=torch.float64)
    Bt = torch.tensor(Bp)
    for _ in range(30):
        JX = jstep(JAe.indices, JAe.values, jlev, jtail, JX, jnp.asarray(Bp))
        X = step(Ae, dp.levels, dp.tail, X, Bt)
        jx = np.asarray(JX)
        np.testing.assert_allclose(X.numpy(), jx, rtol=0,
                                   atol=1e-12 * np.abs(jx).max())
    Xn = X.numpy()[:n]
    res = max(np.linalg.norm(B[:, k] - A.matvec(Xn[:, k]))
              / np.linalg.norm(B[:, k]) for k in range(4))
    assert res <= 1e-10


# ---------------------------------------------------------------------------
# the distributed trsv: tiled all_gather and halo forms

@pytest.mark.parametrize("lower", [True, False])
def test_sharded_trsv_matches_jax(jmesh_rows, tmesh, lower):
    n = 300
    T = random_strict_triangular(n, lower=lower, seed=4)
    b = np.random.default_rng(1).standard_normal(n)
    jx = np.asarray(jpar.sharded_trsv_apply(
        jpar.shard_trsv_schedule(jmesh_rows, T, lower=lower, chunk=64), b))
    st = tpar.shard_trsv_schedule(tmesh, _port(T), lower=lower, chunk=64)
    x = _np(tpar.sharded_trsv_apply(st, b))
    xr = T.solve_as_strict_lower(b) if lower else T.solve_as_strict_upper(b)
    np.testing.assert_allclose(x, xr, atol=1e-10)
    np.testing.assert_allclose(x, jx, atol=1e-10)


def _assert_halo_plans_equal(op, jop, mesh):
    """The port's HaloOp against the JAX HaloOp: every static field and
    count, and every per-rank array, equal."""
    for f in ("meta", "nchunks", "Cloc", "own_len", "buf_len", "D", "n",
              "comm_elems", "allgather_elems"):
        assert getattr(op, f) == getattr(jop, f), f
    col = lambda xs: _np(mesh.collect(xs))  # noqa: E731
    np.testing.assert_array_equal(col(op.in_rows), np.asarray(jop.in_rows))
    np.testing.assert_array_equal(op.out_slots, np.asarray(jop.out_slots))
    for c in range(op.nchunks):
        np.testing.assert_array_equal(col(op.gcols[c]),
                                      np.asarray(jop.gcols[c]))
        np.testing.assert_array_equal(col(op.gvals[c]),
                                      np.asarray(jop.gvals[c]))
        assert len(op.sends[c]) == len(jop.sends[c])
        for s, js in zip(op.sends[c], jop.sends[c]):
            np.testing.assert_array_equal(col(s), np.asarray(js))


@pytest.mark.parametrize("lower", [True, False])
def test_halo_trsv_plan_and_solve_match_jax(jmesh_rows, tmesh, lower):
    """The halo trsv: the port's plan equals the JAX plan array by array,
    the solve is exact (1e-10, the JAX test's) and moves strictly less
    than the tiled all_gather scheme."""
    n = 400
    T = random_strict_triangular(n, lower=lower, seed=9)
    jop = jpar.build_halo_op(jmesh_rows, T, lower=lower, chunk=64)
    op = tpar.build_halo_op(tmesh, _port(T), lower=lower, chunk=64)
    _assert_halo_plans_equal(op, jop, tmesh)
    b = np.random.default_rng(1).standard_normal(n)
    jx = np.asarray(jpar.halo_trsv_apply(jop, b))
    x = _np(tpar.halo_trsv_apply(op, b))
    xr = T.solve_as_strict_lower(b) if lower else T.solve_as_strict_upper(b)
    np.testing.assert_allclose(x, xr, atol=1e-10)
    np.testing.assert_allclose(x, jx, atol=1e-10)
    assert 0 < op.comm_elems < op.allgather_elems
    # the chunk cap: None, as in the JAX package, past max_chunks
    assert tpar.build_halo_op(tmesh, _port(T), lower=lower, chunk=64,
                              max_chunks=op.nchunks - 1) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exchange_plan_matches_jax(jmesh_rows, tmesh, seed):
    """``build_exchange_plan`` equals the JAX plan (sends, fetch, meta,
    counts) on need lists that mix neighbour, far and dead entries, and
    ``xplan_fetch`` fetches every rank's entries (dead ones zero)."""
    rng = np.random.default_rng(seed)
    n, blk, D = 150, 20, 8
    near = np.arange(D)[:, None] * blk + rng.integers(-25, 45, (D, 30))
    far = rng.integers(0, n + 10, (D, 6 * seed))
    need = np.clip(np.concatenate([near, far], 1), 0, n + 5)
    jp = jexchange.build_exchange_plan(jmesh_rows, n, blk, need)
    tp = tpar.build_exchange_plan(tmesh, n, blk, need)
    assert tp.meta == jp.meta
    assert (tp.comm_elems, tp.allgather_elems) == (jp.comm_elems,
                                                   jp.allgather_elems)
    assert len(tp.sends) == len(jp.sends)
    for s, js in zip(tp.sends, jp.sends):
        np.testing.assert_array_equal(_np(tmesh.collect(s)), np.asarray(js))
    np.testing.assert_array_equal(_np(tmesh.collect(tp.fetch)),
                                  np.asarray(jp.fetch))
    y = rng.standard_normal(D * blk)
    y[n:] = 0.0
    got = _np(tmesh.collect(tpar.xplan_fetch(
        tp, tmesh.put(y.reshape(D, blk)))))
    want = np.where(need < n, np.concatenate([y, [0.0]])[
        np.minimum(need, n)], 0.0)
    np.testing.assert_array_equal(got, want)


def test_k1_refuses_32_bit_overflow():
    """K1's wrapper names the 2**31 limit when X's or C's rows times the
    column count reach it; the shapes are zero-stride views, so nothing
    large is allocated."""
    from hifir_tpu_torch.ops.spmv import ELL, sell_spmv_cuda

    n, nrhs = 2**31 // 8 + 1, 8
    A = ELL(torch.zeros((1, 1), dtype=torch.int32).expand(n, 1),
            torch.zeros((1, 1)).expand(n, 1), n, n)
    X = torch.zeros((1, 1)).expand(n, nrhs)
    with pytest.raises(ValueError, match=r"2\*\*31"):
        sell_spmv_cuda(A, X)
    small = ELL(torch.zeros((4, 1), dtype=torch.int32), torch.zeros((4, 1)),
                4, n)
    with pytest.raises(ValueError, match=r"X rows .* 2\*\*31"):
        sell_spmv_cuda(small, X)
    C = torch.zeros((1, 1)).expand(n, nrhs)
    Xs = torch.zeros((4, nrhs))
    wide = ELL(torch.zeros((1, 1), dtype=torch.int32).expand(n, 1),
               torch.zeros((1, 1)).expand(n, 1), n, 4)
    with pytest.raises(ValueError, match=r"C rows .* 2\*\*31"):
        sell_spmv_cuda(wide, Xs, C)
