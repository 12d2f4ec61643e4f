"""The redesigned kernels' arithmetic and launch choices, on the CPU.

K7's f32 tensor-core path multiplies in split TF32 (3xTF32); a plain-torch
emulation of that scheme, rounding to TF32 by the ``cvt.rna`` bit rule,
must reproduce the f64 product within 1e-6 of max|Y| while one TF32 pass
misses 1e-4, so the test tells the two apart.  K2's plain version (B to X)
is held to the JAX package's ``trsv_apply_mrhs`` at f64 rtol 1e-12.  The
pure-Python shape choices of K7 and K2 are checked on each side of their
thresholds.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from hifir_tpu.ds import CSR as JCSR
from hifir_tpu.models import random_strict_triangular
from hifir_tpu.ops import trsv as jtrsv

from hifir_tpu_torch.ds.csr import CSR
from hifir_tpu_torch.ops import bsr_spmv, trsv

CPU = "cpu"


def _port(A) -> CSR:
    return CSR(A.nrows, A.ncols, A.indptr, A.indices, A.data)


# ---------------------------------------------------------------------------
# K7: the 3xTF32 scheme


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32``
    does: to nearest, ties away from zero, low 13 bits cleared."""
    b = x.view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _bsr_operands(seed, nbr=6, kb=3, bs=32, nrhs=8):
    rng = np.random.default_rng(seed)
    blocks = rng.standard_normal((nbr, kb, bs, bs))
    bcols = rng.integers(0, nbr, (nbr, kb))
    X = rng.standard_normal((nbr * bs, nrhs))
    G = X.reshape(nbr, bs, nrhs)[bcols]          # (nbr, KB, bs, nrhs)
    Y = np.einsum("ikab,ikbj->iaj", blocks, G).reshape(-1, nrhs)
    return (torch.from_numpy(blocks.astype(np.float32)),
            torch.from_numpy(G.astype(np.float32)), Y)


def _blockwise(a, g):
    return torch.einsum("ikab,ikbj->iaj", a, g).reshape(-1, g.shape[-1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tf32x3_scheme_reaches_f32_accuracy(seed):
    A, G, Y = _bsr_operands(seed)
    a_hi, g_hi = _tf32(A), _tf32(G)
    a_lo, g_lo = _tf32(A - a_hi), _tf32(G - g_hi)
    # each TF32 x TF32 product is exact in f32; the kernel sums the small
    # products first
    Y3 = (_blockwise(a_lo, g_hi) + _blockwise(a_hi, g_lo)
          + _blockwise(a_hi, g_hi))
    Y1 = _blockwise(a_hi, g_hi)
    scale = np.abs(Y).max()
    assert np.abs(Y3.double().numpy() - Y).max() <= 1e-6 * scale
    assert np.abs(Y1.double().numpy() - Y).max() > 1e-4 * scale


def test_tf32_rounding_rule():
    """Ties round away from zero; the result has 10 mantissa bits."""
    one = 1.0
    ulp = 2.0 ** -10                       # TF32 spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4], dtype=torch.float32)
    np.testing.assert_array_equal(
        _tf32(x).numpy(),
        np.array([one + ulp, -(one + ulp), one, one + ulp], np.float32))
    r = _tf32(torch.randn(1000, generator=torch.Generator().manual_seed(0)))
    assert not (r.view(torch.int32) & 0x1FFF).any()


# ---------------------------------------------------------------------------
# K2: the plain version, B to X


def _wide_triangle(n, lower, seed):
    """Random strict triangle plus a few dense rows, so k_cap splits rows."""
    rng = np.random.default_rng(seed)
    T = random_strict_triangular(n, lower=lower, seed=seed)
    M = sp.csr_matrix((T.data, T.indices, T.indptr), shape=(n, n)).tolil()
    for i in (120, 150, 199) if lower else (0, 40, 80):
        js = np.arange(i) if lower else np.arange(i + 1, n)
        M[i, js] = rng.standard_normal(js.size) * 0.1
    return JCSR.from_scipy(M.tocsr())


@pytest.mark.parametrize("nrhs", [1, 5])
@pytest.mark.parametrize("lower", [True, False])
def test_k2_apply_plain_matches_reference(nrhs, lower):
    T = _wide_triangle(200, lower, 11)
    s = trsv.build_trsv_schedule(_port(T), lower=lower, chunk=16,
                                 k_cap="auto", device=CPU)
    assert s.cols.shape[2] < 100          # rows were split
    js = jtrsv.build_trsv_schedule(T, lower=lower, chunk=16, k_cap="auto")
    B = np.random.default_rng(7).standard_normal((T.nrows, nrhs))
    X = trsv.trsv_apply_plain(s, torch.from_numpy(B))
    Xj = np.asarray(jtrsv.trsv_apply_mrhs(js, jnp.asarray(B)))
    assert X.shape == (T.nrows, nrhs)
    np.testing.assert_allclose(X.numpy(), Xj, rtol=1e-12,
                               atol=1e-12 * np.abs(Xj).max())


@pytest.mark.parametrize("lower", [True, False])
def test_k2_apply_plain_solves_the_system(lower):
    """(I + strict(T)) X = B holds for the plain version's X, to rounding
    relative to |I + strict(T)| |X|."""
    T = _wide_triangle(200, lower, 5)
    s = trsv.build_trsv_schedule(_port(T), lower=lower, chunk="auto",
                                 k_cap="auto", device=CPU)
    B = np.random.default_rng(8).standard_normal((T.nrows, 3))
    X = trsv.trsv_apply_plain(s, torch.from_numpy(B)).numpy()
    M = T.to_scipy() + sp.eye(T.nrows)
    scale = abs(M) @ np.abs(X)
    assert np.all(np.abs(M @ X - B) <= 1e-13 * scale)


@pytest.mark.parametrize("kind", ["random", "wide", "empty"])
@pytest.mark.parametrize("lower", [True, False])
def test_schedule_device_level_slots_equal_host(kind, lower):
    if kind == "random":
        T = _port(random_strict_triangular(150, lower=lower, seed=3))
    elif kind == "wide":
        T = _port(_wide_triangle(200, lower, 11))
    else:
        T = CSR(0, 0, np.zeros(1, np.int64), np.empty(0, np.int32),
                np.empty(0))
    s = trsv.build_trsv_schedule(T, lower=lower, chunk=16, k_cap="auto",
                                 device=CPU)
    assert s.level_slots_dev.dtype == torch.int64
    assert s.level_slots_dev.shape == (s.nlevels + 1,)
    np.testing.assert_array_equal(s.level_slots_dev.numpy(), s.level_slots)


# ---------------------------------------------------------------------------
# launch-shape choices


def test_k7_path_choice():
    edge = bsr_spmv.STREAM_MAX_NRHS
    assert edge == 2            # what the streaming kernel takes
    for dt, tensor in ((torch.float32, "tf32x3"), (torch.float64, "dmma")):
        assert bsr_spmv.bsr_path(dt, 1) == "stream"
        assert bsr_spmv.bsr_path(dt, edge) == "stream"
        assert bsr_spmv.bsr_path(dt, edge + 1) == tensor
        assert bsr_spmv.bsr_path(dt, 8) == tensor
        assert bsr_spmv.bsr_path(dt, 128) == tensor


def test_k2_shape_choice():
    shape = trsv.trsv_shape

    # the slot vector (nslots + 1 elements, with the zero sentinel) goes to
    # shared memory while it fits
    for itemsize in (4, 8):
        fits = trsv.SMEM_BYTES // itemsize - 1
        assert shape(fits, itemsize) == "shared"
        assert shape(fits + 1, itemsize) == "global"
    # the fixture's level-0 L_B (37888 slots): shared in f32, global in f64;
    # its level-1 factors fit in both
    assert shape(37888, 4) == "shared"
    assert shape(37888, 8) == "global"
    assert shape(4384, 8) == "shared"


@pytest.mark.parametrize("chunk,ring", [(16, True), (6, False)])
def test_k2_ring_needs_whole_lines(chunk, ring):
    """The ring copies a level's rows in 16-byte lines: only schedules whose
    levels are whole multiples of 4 slots get one."""
    T = _port(random_strict_triangular(150, lower=True, seed=3))
    s = trsv.build_trsv_schedule(T, lower=True, chunk=chunk, device=CPU)
    width = trsv._ring_width(s)
    assert (width > 0) == ring
    if ring:
        assert width == int(np.diff(s.level_slots).max())
