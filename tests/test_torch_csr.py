"""The port's host CSR (``hifir_tpu_torch/ds/csr.py``) against the JAX
package's (``hifir_tpu/ds/csr.py``) where the port repeats its methods:
``identity``, ``copy``, ``permute`` and ``prune``, on seeded matrices
(square and rectangular, empty rows, duplicates summed), exactly."""

import numpy as np
import pytest

from hifir_tpu.ds.csr import CSR as JCSR

from hifir_tpu_torch.ds.csr import CSR


def _pair(seed: int, nrows: int, ncols: int, density: float, dtype):
    """The same seeded random matrix in both packages (some rows empty,
    duplicates in the triplets, some entries tiny)."""
    rng = np.random.default_rng(seed)
    nnz = int(density * nrows * ncols)
    rows = rng.integers(0, nrows, nnz)
    cols = rng.integers(0, ncols, nnz)
    vals = rng.standard_normal(nnz) * rng.choice([1.0, 1e-9], nnz)
    if np.dtype(dtype).kind == "c":
        vals = vals + 1j * rng.standard_normal(nnz)
    vals = vals.astype(dtype)
    rows[rows == nrows // 2] = 0        # an empty row
    return (CSR.from_coo(nrows, ncols, rows, cols, vals),
            JCSR.from_coo(nrows, ncols, rows, cols, vals))


def _equal(A, J):
    assert (A.nrows, A.ncols) == (J.nrows, J.ncols)
    np.testing.assert_array_equal(A.indptr, J.indptr)
    np.testing.assert_array_equal(A.indices, J.indices)
    np.testing.assert_array_equal(A.data, J.data)
    assert A.data.dtype == J.data.dtype
    A.check_validity()


@pytest.mark.parametrize("n", [0, 1, 7])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128])
def test_identity(n, dtype):
    _equal(CSR.identity(n, dtype), JCSR.identity(n, dtype))


def test_copy_is_deep():
    A, J = _pair(0, 30, 20, 0.2, np.float64)
    B = A.copy()
    _equal(B, J.copy())
    for a, b in ((A.indptr, B.indptr), (A.indices, B.indices),
                 (A.data, B.data)):
        assert not np.shares_memory(a, b)
    B.data[:] = 0
    _equal(A, J)


@pytest.mark.parametrize("shape", [(40, 40), (25, 60)])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("seed", [1, 2])
def test_permute(shape, dtype, seed):
    """Rows taken in a permuted order and columns remapped by a permutation
    (each row's columns sorted again), as the JAX ``permute`` does."""
    A, J = _pair(seed, *shape, 0.15, dtype)
    rng = np.random.default_rng(seed + 10)
    p = rng.permutation(shape[0])
    q_inv = rng.permutation(shape[1])
    _equal(A.permute(p, q_inv), J.permute(p, q_inv))
    _equal(A.permute(np.arange(shape[0]), np.arange(shape[1])), J)


@pytest.mark.parametrize("tol", [0.0, 1e-6, 0.5])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128])
def test_prune(tol, dtype):
    A, J = _pair(3, 35, 30, 0.2, dtype)
    A.data[::7] = 0
    J.data[::7] = 0
    _equal(A.prune(tol), J.prune(tol))
