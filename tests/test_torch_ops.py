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


def test_sliced_ell_row_table_addresses_buckets():
    """row_ptr/row_len (the kernel's table) point at each row's bucket row."""
    A = random_sparse(300, 40, seed=5, ncols=90)
    s = spmv.sliced_ell_from_csr(_port(A), device=CPU)
    pos = s.inv_order.long()
    starts = np.cumsum([0] + [b.nrows for b in s.blocks])
    for r in range(A.nrows):
        b = int(np.searchsorted(starts, int(pos[r]), side="right")) - 1
        o = int(pos[r]) - starts[b]
        K = s.blocks[b].k
        assert int(s.row_len[r]) == K
        p = int(s.row_ptr[r])
        np.testing.assert_array_equal(s.flat_indices[p:p + K].numpy(),
                                      s.blocks[b].indices[o].numpy())


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


def test_kernel_launchers_refuse_cpu_tensors():
    """The launchers never fall back: a CPU operand is refused before any
    build or launch (the plain versions are chosen only by the public
    wrappers, from the tensor's device)."""
    A = poisson2d(16)
    s = spmv.sliced_ell_from_csr(_port(A), device=CPU)
    b = bsr_spmv.bsr_from_csr(_port(A), bs=64, device=CPU)
    T = trsv.build_trsv_schedule(_port(_triangles()["random"](True)),
                                 lower=True, chunk=8, device=CPU)
    X = torch.zeros((A.nrows, 2), dtype=torch.float64)
    x = torch.zeros((T.nchunks * T.chunk + 1, 2), dtype=torch.float64)
    for launch in (lambda: spmv.sell_spmv_cuda(s, X),
                   lambda: bsr_spmv.bsr_spmv_cuda(b, X),
                   lambda: trsv.trsv_scan_cuda(T, x)):
        with pytest.raises(ValueError, match="CUDA"):
            launch()
    assert (spmv.sell_spmv_cuda.launches, bsr_spmv.bsr_spmv_cuda.launches,
            trsv.trsv_scan_cuda.launches) == (0, 0, 0)
