"""The port's packers and plain kernel versions against the JAX package.

Inputs come from numpy seeds and go through both packages.  Packed arrays
must be equal (index arrays exactly, values at zero tolerance); products
must agree to rtol 1e-12 in f64 and to 1e-5 of max|Y| in f32 (the sums run
in another order).  The JAX Pallas kernel runs in interpret mode, as
``tests/test_pallas.py`` runs it.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from hifir_tpu.ds import CSR as JCSR
from hifir_tpu.models import (convdiff2d, poisson2d, random_sparse,
                              random_strict_triangular)
from hifir_tpu.ops import pallas_spmv as jbsr
from hifir_tpu.ops import spmv as jspmv
from hifir_tpu.ops import trsv as jtrsv

from hifir_tpu_torch.ds.csr import CSR
from hifir_tpu_torch.models.problems import poisson2d as tpoisson2d
from hifir_tpu_torch.ops import bsr_spmv, spmv, trsv

CPU = "cpu"


def _port(A) -> CSR:
    return CSR(A.nrows, A.ncols, A.indptr, A.indices, A.data)


def _eq(t, a):
    """Exact equality, dtype included, of a port tensor and a JAX array."""
    a = np.asarray(a)
    t = t.numpy()
    assert t.dtype == a.dtype and t.shape == a.shape
    np.testing.assert_array_equal(t, a)


def _eq_ell(e, je):
    _eq(e.indices, je.indices)
    _eq(e.values, je.values)
    assert (e.nrows, e.ncols) == (je.nrows, je.ncols)


def _eq_sliced(s, js):
    assert len(s.blocks) == len(js.blocks)
    for b, jb in zip(s.blocks, js.blocks):
        _eq_ell(b, jb)
    _eq(s.inv_order, js.inv_order)
    assert (s.nrows, s.ncols) == (js.nrows, js.ncols)


def _eq_sched(s, js):
    for f in ("in_rows", "cols", "vals", "out_slots"):
        _eq(getattr(s, f), getattr(js, f))
    assert ((s.n, s.nchunks, s.chunk, s.nlevels)
            == (js.n, js.nchunks, js.chunk, js.nlevels))
    # the level ranges the JAX pytree drops tile the slots exactly
    assert s.level_slots.shape == (s.nlevels + 1,)
    assert s.level_slots[0] == 0 and s.level_slots[-1] == s.nchunks * s.chunk
    assert np.all(np.diff(s.level_slots) > 0)
    assert np.all(s.level_slots % s.chunk == 0)


def _wide_triangle(n, lower, seed):
    """Random strict triangle plus a few dense rows, so k_cap splits rows."""
    rng = np.random.default_rng(seed)
    T = random_strict_triangular(n, lower=lower, seed=seed)
    M = sp.csr_matrix((T.data, T.indices, T.indptr), shape=(n, n)).tolil()
    for i in (120, 150, 199) if lower else (0, 40, 80):
        js = np.arange(i) if lower else np.arange(i + 1, n)
        M[i, js] = rng.standard_normal(js.size) * 0.1
    return JCSR.from_scipy(M.tocsr())


def _triangles():
    return {
        "random": lambda lower: random_strict_triangular(150, lower=lower,
                                                         seed=3),
        "convdiff": lambda lower: JCSR.from_scipy(
            (sp.tril if lower else sp.triu)(convdiff2d(12).to_scipy(),
                                            -1 if lower else 1).tocsr()),
        "wide": lambda lower: _wide_triangle(200, lower, 11),
    }


# ---------------------------------------------------------------------------
# packers


@pytest.mark.parametrize("dtype", [None, np.float32])
def test_ell_packers_equal_reference(dtype):
    A = random_sparse(120, 9, seed=2, ncols=77)
    _eq_ell(spmv.ell_from_csr(_port(A), dtype=dtype, device=CPU),
            jspmv.ell_from_csr(A, dtype=dtype))
    _eq_sliced(spmv.sliced_ell_from_csr(_port(A), dtype=dtype, device=CPU),
               jspmv.sliced_ell_from_csr(A, dtype=dtype))


def _with_empty_rows(A, every=3):
    """A copy of A whose rows 0, every, 2 every, ... have no entries."""
    M = A.to_scipy().tolil()
    M[::every] = 0
    M = M.tocsr()
    M.eliminate_zeros()
    return JCSR.from_scipy(M)


def test_sliced_ell_row_table_addresses_buckets():
    """K1's table (order, pos_ptr, pos_nnz by position in the bucket
    concatenation) points at each row's bucket row, counts its CSR entries,
    and puts the rows without entries first."""
    A = _with_empty_rows(random_sparse(300, 40, seed=5, ncols=90))
    counts = np.diff(A.indptr)
    s = spmv.sliced_ell_from_csr(_port(A), device=CPU)
    for t in (s.order, s.pos_ptr, s.pos_nnz):
        assert t.dtype == torch.int32 and t.shape == (A.nrows,)
    order = s.order.numpy()
    np.testing.assert_array_equal(s.inv_order.numpy()[order],
                                  np.arange(A.nrows))
    np.testing.assert_array_equal(s.pos_nnz.numpy(), counts[order])
    assert s.nempty == np.count_nonzero(counts == 0) > 0
    assert not s.pos_nnz[:s.nempty].any() and s.pos_nnz[s.nempty:].all()
    assert (s.max_nnz, s.nnz) == (counts.max(), counts.sum())
    starts = np.cumsum([0] + [b.nrows for b in s.blocks])
    for p, r in enumerate(order):
        b = int(np.searchsorted(starts, p, side="right")) - 1
        K = s.blocks[b].k
        q, c = int(s.pos_ptr[p]), counts[r]
        np.testing.assert_array_equal(s.flat_indices[q:q + K].numpy(),
                                      s.blocks[b].indices[p - starts[b]])
        # the true entries, then only pads
        np.testing.assert_array_equal(s.flat_indices[q:q + c].numpy(),
                                      A.indices[A.indptr[r]:A.indptr[r + 1]])
        assert (s.flat_indices[q + c:q + K] == A.ncols).all()


@pytest.mark.parametrize("nx,bs", [(24, 128), (16, 64)])
def test_bsr_packer_equal_reference(nx, bs):
    A = poisson2d(nx)
    B = bsr_spmv.bsr_from_csr(_port(A), bs=bs, device=CPU)
    JB = jbsr.bsr_from_csr(A, bs=bs)
    _eq(B.blocks, JB.blocks)
    _eq(B.block_cols, JB.block_cols)
    assert (B.n, B.bs, B.nbr, B.kb) == (JB.n, JB.bs, JB.nbr, JB.kb)


def test_poisson2d_copy_equal_reference():
    A, J = tpoisson2d(9, 7), poisson2d(9, 7)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(A, f), getattr(J, f))


@pytest.mark.parametrize("kind", ["random", "convdiff", "wide"])
@pytest.mark.parametrize("lower", [True, False])
def test_compute_levels_equal_reference(kind, lower):
    T = _triangles()[kind](lower)
    lev = trsv._compute_levels(T.nrows, T.indptr, T.indices, lower)
    ref = jtrsv._compute_levels(T.nrows, T.indptr, T.indices, lower)
    np.testing.assert_array_equal(lev, ref)


@pytest.mark.parametrize("kind,chunk,k_cap", [
    ("random", 8, None), ("random", 64, None), ("random", "auto", "auto"),
    ("convdiff", 16, "auto"), ("convdiff", "auto", "auto"),
    ("wide", 16, None), ("wide", 16, 4), ("wide", 16, "auto"),
    ("wide", "auto", "auto")])
@pytest.mark.parametrize("lower", [True, False])
def test_trsv_schedule_equal_reference(kind, chunk, k_cap, lower):
    T = _triangles()[kind](lower)
    s = trsv.build_trsv_schedule(_port(T), lower=lower, chunk=chunk,
                                 k_cap=k_cap, device=CPU)
    _eq_sched(s, jtrsv.build_trsv_schedule(T, lower=lower, chunk=chunk,
                                           k_cap=k_cap))
    if kind == "wide" and k_cap is not None:
        assert s.cols.shape[2] < 100   # rows were split: K is not max degree


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("dtype", [None, np.float32])
def test_trsv_dense_forms_equal_reference(lower, dtype):
    T = _triangles()["convdiff"](lower)
    d = trsv.build_trsv_dense(_port(T), lower=lower, dtype=dtype, device=CPU)
    jd = jtrsv.build_trsv_dense(T, lower=lower, dtype=dtype)
    _eq(d.inv, jd.inv)
    bd = trsv.build_trsv_block_dense(_port(T), lower=lower, W=16,
                                     dtype=dtype, device=CPU)
    jbd = jtrsv.build_trsv_block_dense(T, lower=lower, W=16, dtype=dtype)
    assert (bd.starts, bd.n, bd.W) == (jbd.starts, jbd.n, jbd.W)
    for a, ja in zip(bd.invs, jbd.invs):
        _eq(a, ja)
    for o, jo in zip(bd.offs, jbd.offs):
        _eq_sliced(o, jo)


# ---------------------------------------------------------------------------
# plain kernel versions (K1, K7, K2) against the JAX functions


def _close(Y, Yref, dtype):
    Y, Yref = np.asarray(Y, np.float64), np.asarray(Yref, np.float64)
    if dtype == np.float64:
        np.testing.assert_allclose(Y, Yref, rtol=1e-12,
                                   atol=1e-12 * np.abs(Yref).max())
    else:
        assert np.abs(Y - Yref).max() <= 1e-5 * np.abs(Yref).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("sliced", [True, False])
def test_k1_plain_matches_reference(dtype, sliced):
    A = random_sparse(120, 9, seed=2, ncols=77)
    X = np.random.default_rng(1).standard_normal((77, 6)).astype(dtype)
    pack, jpack = ((spmv.sliced_ell_from_csr, jspmv.sliced_ell_from_csr)
                   if sliced else (spmv.ell_from_csr, jspmv.ell_from_csr))
    Y = spmv.ell_matvec_mrhs(pack(_port(A), dtype=dtype, device=CPU),
                             torch.from_numpy(X))
    Yj = jspmv.ell_matvec_mrhs(jpack(A, dtype=dtype), jnp.asarray(X))
    _close(Y, Yj, dtype)
    y = spmv.ell_matvec(pack(_port(A), dtype=dtype, device=CPU),
                        torch.from_numpy(X[:, 0]))
    _close(y, np.asarray(Yj)[:, 0], dtype)


def test_k1_plain_empty_operator():
    """A 0-column E (a level with m == 0) multiplies to zeros."""
    E = CSR(5, 0, np.zeros(6, np.int64), np.empty(0, np.int32),
            np.empty(0))
    Y = spmv.ell_matvec_mrhs(spmv.sliced_ell_from_csr(E, device=CPU),
                             torch.zeros((0, 3), dtype=torch.float64))
    assert Y.shape == (5, 3) and not Y.any()


@pytest.mark.parametrize("op", ["empty_rows", "empty"])
@pytest.mark.parametrize("in_place", [True, False])
@pytest.mark.parametrize("nrhs", [1, 5])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("sliced", [True, False])
def test_k1_fused_plain_matches_reference(op, in_place, nrhs, dtype, sliced):
    """out = C - A X against the JAX package's C - ell_matvec_mrhs(A, X), in
    place (out is C) and out of place; an operator without entries gives C
    itself (in place) or a copy of it."""
    A = _with_empty_rows(random_sparse(120, 9, seed=2, ncols=77))
    if op == "empty":
        A = JCSR.from_scipy(sp.csr_matrix((120, 77)))
    rng = np.random.default_rng(6)
    X = rng.standard_normal((77, nrhs)).astype(dtype)
    C = rng.standard_normal((120, nrhs)).astype(dtype)
    pack, jpack = ((spmv.sliced_ell_from_csr, jspmv.sliced_ell_from_csr)
                   if sliced else (spmv.ell_from_csr, jspmv.ell_from_csr))
    Ct = torch.from_numpy(C.copy())
    out = Ct if in_place else torch.empty_like(Ct)
    Y = spmv.sliced_ell_sub_mrhs(pack(_port(A), dtype=dtype, device=CPU),
                                 torch.from_numpy(X), Ct, out=out)
    assert Y is out
    if not in_place:
        np.testing.assert_array_equal(Ct.numpy(), C)   # C left as it was
    Yj = C - np.asarray(jspmv.ell_matvec_mrhs(jpack(A, dtype=dtype),
                                              jnp.asarray(X)))
    _close(Y, Yj, dtype)
    if op == "empty":
        np.testing.assert_array_equal(Y.numpy(), C)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nx,bs,nrhs", [(24, 128, 8), (16, 64, 1)])
def test_k7_plain_matches_reference(dtype, nx, bs, nrhs):
    A = poisson2d(nx)
    B = bsr_spmv.bsr_from_csr(_port(A), bs=bs, dtype=dtype, device=CPU)
    npad = B.nbr * B.bs
    X = np.random.default_rng(3).standard_normal((npad, nrhs)).astype(dtype)
    X[A.nrows:] = 0
    Y = bsr_spmv.bsr_matvec_mrhs(B, torch.from_numpy(X))
    Yj = jbsr.bsr_matvec_mrhs(jbsr.bsr_from_csr(A, bs=bs, dtype=dtype),
                              jnp.asarray(X), interpret=True)
    _close(Y, Yj, dtype)
    # through the operator dispatch, unpadded
    Yd = spmv.ell_matvec_mrhs(B, torch.from_numpy(X[:A.nrows]))
    _close(Yd, np.asarray(Yj)[:A.nrows], dtype)


@pytest.mark.parametrize("form", ["schedule", "dense", "block"])
@pytest.mark.parametrize("lower", [True, False])
def test_k2_trsv_apply_matches_reference(form, lower):
    T = _triangles()["wide"](lower)
    B = np.random.default_rng(4).standard_normal((T.nrows, 5))
    if form == "schedule":
        s = trsv.build_trsv_schedule(_port(T), lower=lower, chunk=16,
                                     k_cap="auto", device=CPU)
        js = jtrsv.build_trsv_schedule(T, lower=lower, chunk=16, k_cap="auto")
    elif form == "dense":
        s = trsv.build_trsv_dense(_port(T), lower=lower, device=CPU)
        js = jtrsv.build_trsv_dense(T, lower=lower)
    else:
        s = trsv.build_trsv_block_dense(_port(T), lower=lower, W=64,
                                        device=CPU)
        js = jtrsv.build_trsv_block_dense(T, lower=lower, W=64)
    X = trsv.trsv_apply_mrhs(s, torch.from_numpy(B))
    Xj = jtrsv.trsv_apply_mrhs(js, jnp.asarray(B))
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(Xj)).max())


@pytest.mark.parametrize("nrhs", [1, 5])
@pytest.mark.parametrize("W", [16, 64])
@pytest.mark.parametrize("lower", [True, False])
def test_block_dense_apply_matches_reference(nrhs, W, lower):
    """The blocked inverse (K1 with its fused epilogue, then the block's
    inverse) against the JAX package's _block_dense_apply; the first block
    solved on each side has an empty Off_b, and the last block is short."""
    T = _triangles()["wide"](lower)
    bd = trsv.build_trsv_block_dense(_port(T), lower=lower, W=W, device=CPU)
    jbd = jtrsv.build_trsv_block_dense(T, lower=lower, W=W)
    assert bd.offs[0].nnz == 0 and all(o.nnz for o in bd.offs[1:])
    assert T.nrows % W
    B = np.random.default_rng(9).standard_normal((T.nrows, nrhs))
    X = trsv._block_dense_apply(bd, torch.from_numpy(B))
    Xj = np.asarray(jtrsv._block_dense_apply(jbd, jnp.asarray(B)))
    assert X.shape == (T.nrows, nrhs)
    np.testing.assert_allclose(X.numpy(), Xj, rtol=1e-12,
                               atol=1e-12 * np.abs(Xj).max())


@pytest.mark.parametrize("lower", [True, False])
def test_block_offdiag_columns_outside_block(lower):
    """Off_b reads no row of its own block, so K1 may write the block's rows
    while it reads the solution buffer."""
    T = _triangles()["convdiff"](lower)
    bd = trsv.build_trsv_block_dense(_port(T), lower=lower, W=16, device=CPU)
    for off, lo in zip(bd.offs, bd.starts):
        cols = off.flat_indices[off.flat_indices < off.ncols]
        assert not ((cols >= lo) & (cols < lo + bd.W)).any()
        assert (cols < lo).all() if lower else (cols >= lo + bd.W).all()


def test_k1_launcher_checks_operands():
    """Before any build or launch: out may not overlap X or share part of
    C's memory, and C and out take A's row count."""
    A = poisson2d(16)
    s = spmv.sliced_ell_from_csr(_port(A), device=CPU)
    X = torch.zeros((A.nrows, 4), dtype=torch.float64)
    buf = torch.zeros((2 * A.nrows, 4), dtype=torch.float64)
    for kw, msg in ((dict(out=X), "overlaps X"),
                    (dict(C=buf[:A.nrows], out=buf[1:A.nrows + 1]),
                     "partly overlaps C"),
                    (dict(C=buf), "expected")):
        with pytest.raises(ValueError, match=msg):
            spmv.sell_spmv_cuda(s, X, **kw)
    assert spmv.sell_spmv_cuda.launches == 0


def test_kernel_launchers_refuse_cpu_tensors():
    """The launchers never fall back: a CPU operand is refused before any
    build or launch (the plain versions are chosen only by the public
    wrappers, from the tensor's device)."""
    A = poisson2d(16)
    s = spmv.sliced_ell_from_csr(_port(A), device=CPU)
    b = bsr_spmv.bsr_from_csr(_port(A), bs=64, device=CPU)
    T = trsv.build_trsv_schedule(_port(_triangles()["random"](True)),
                                 lower=True, chunk=8, device=CPU)
    e = spmv.ell_from_csr(_port(A), device=CPU)
    X = torch.zeros((A.nrows, 2), dtype=torch.float64)
    C = torch.zeros((A.nrows, 2), dtype=torch.float64)
    B = torch.zeros((T.n, 2), dtype=torch.float64)
    launches = [lambda: spmv.sell_spmv_cuda(s, X),
                lambda: bsr_spmv.bsr_spmv_cuda(b, X)]
    # K1's fused entry: in place, out of place, uniform ELL, one column
    launches += [lambda: spmv.sell_spmv_cuda(s, X, C, C),
                 lambda: spmv.sell_spmv_cuda(s, X, C, torch.empty_like(C)),
                 lambda: spmv.sell_spmv_cuda(e, X, C),
                 lambda: spmv.sell_spmv_cuda(s, X[:, :1].contiguous(),
                                             C[:, :1].contiguous())]
    launches += [lambda p=p: bsr_spmv.bsr_spmv_cuda(b, X, path=p)
                 for p in ("stream", "dmma")]
    launches += [lambda Bt=Bt: trsv.trsv_apply_cuda(T, Bt)
                 for Bt in (B, B[:, :1].contiguous())]
    for launch in launches:
        with pytest.raises(ValueError, match="CUDA"):
            launch()
    assert (spmv.sell_spmv_cuda.launches, bsr_spmv.bsr_spmv_cuda.launches,
            trsv.trsv_apply_cuda.launches) == (0, 0, 0)
