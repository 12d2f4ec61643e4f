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
# K2: the card schedule (a K and a split cap a level, no chunk padding)


def _card_triangle(kind, lower, complex_):
    T = (_wide_triangle(200, lower, 11) if kind == "wide"
         else random_strict_triangular(300, lower=lower, seed=4))
    if complex_:
        phase = np.exp(2j * np.pi * np.random.default_rng(3).random(
            T.data.size))
        T = JCSR(T.nrows, T.ncols, T.indptr, T.indices, T.data * phase)
    return T


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("kind", ["wide", "random"])
@pytest.mark.parametrize("lower", [True, False])
def test_k2_card_schedule_matches_reference(kind, lower, complex_):
    """The plain solve on the card schedule equals the JAX package's solve
    on its own schedule, and solves the system to rounding."""
    T = _card_triangle(kind, lower, complex_)
    s = trsv.build_trsv_schedule_card(_port(T), lower, device=CPU)
    assert s.chunk == 1 and s.cols.dim() == 1
    js = jtrsv.build_trsv_schedule(T, lower=lower, chunk=16, k_cap="auto")
    rng = np.random.default_rng(9)
    B = rng.standard_normal((T.nrows, 4))
    if complex_:
        B = B + 1j * rng.standard_normal(B.shape)
    X = trsv.trsv_apply_plain(s, torch.from_numpy(B)).numpy()
    Xj = np.asarray(jtrsv.trsv_apply_mrhs(js, jnp.asarray(B)))
    np.testing.assert_allclose(X, Xj, rtol=1e-12,
                               atol=1e-12 * np.abs(Xj).max())
    M = T.to_scipy() + sp.eye(T.nrows)
    assert np.all(np.abs(M @ X - B) <= 1e-13 * (abs(M) @ np.abs(X)))


@pytest.mark.parametrize("kind", ["wide", "random"])
@pytest.mark.parametrize("lower", [True, False])
def test_k2_card_schedule_invariants(kind, lower):
    """Each level's K is a multiple of 4, at least its widest slot and less
    than 4 above it; every slot depends only on slots of earlier levels
    (or the zero sentinel, nslots); the effective levels lie between the
    dependency graph's depth and the reference schedule's count; the
    device tables equal the host's."""
    T = _port(_card_triangle(kind, lower, False))
    s = trsv.build_trsv_schedule_card(T, lower, device=CPU)
    ref = trsv.build_trsv_schedule(T, lower=lower, chunk="auto",
                                   k_cap="auto", device=CPU)
    depth = int(trsv._compute_levels(T.nrows, T.indptr, T.indices,
                                     lower).max()) + 1
    assert depth <= s.nlevels <= ref.nlevels
    assert np.all(s.level_K % 4 == 0)
    cols = s.cols.numpy()
    assert s.level_off[-1] == cols.size
    for l in range(s.nlevels):
        s0, s1 = s.level_slots[l], s.level_slots[l + 1]
        K = int(s.level_K[l])
        c = cols[s.level_off[l]:s.level_off[l + 1]].reshape(s1 - s0, K)
        real = c != s.nslots
        width = int(real.sum(1).max())
        assert width <= K < width + 4
        assert np.all(c[real] < s0)
    np.testing.assert_array_equal(s.level_K_dev.numpy(), s.level_K)
    np.testing.assert_array_equal(s.level_off_dev.numpy(), s.level_off)
    np.testing.assert_array_equal(s.level_slots_dev.numpy(), s.level_slots)


def _cost(s, t_level, t_round):
    return (s.nlevels * t_level + t_round * int(trsv._rounds(
        np.diff(s.level_slots), s.level_K).sum()))


def _one_level(widths):
    """A lower strict triangle whose rows ``1..`` form one dependency level
    of the given widths over the first ``max(widths)`` rows."""
    m = max(widths)
    rows = [np.full(w, m + i) for i, w in enumerate(widths)]
    cols = [np.arange(w) for w in widths]
    n = m + len(widths)
    r, c = np.concatenate(rows), np.concatenate(cols)
    M = sp.csr_matrix((np.full(r.size, 0.01), (r, c)), shape=(n, n))
    return _port(JCSR.from_scipy(M)), m


@pytest.mark.parametrize("t_level,t_round", [(1.5, 0.8), (0.1, 1.43),
                                             (0.0, 1.0), (1e4, 1.0)])
@pytest.mark.parametrize("widths", [[8] * 3000, [1000] + [3] * 2000,
                                    [300] * 40 + [2] * 500])
def test_k2_level_caps_take_the_cheapest(widths, t_level, t_round):
    """Equal narrow rows stay unsplit; a level with wide rows splits at
    the cap whose schedule, built, costs least under the constants: the
    cost model's stages and rounds are those of the schedule it builds."""
    T, m = _one_level(widths)
    lev = trsv._compute_levels(T.nrows, T.indptr, T.indices, True)
    dcount = np.diff(T.indptr)
    caps = trsv._level_caps(dcount, lev, t_level, t_round)
    if len(set(widths)) == 1:
        assert caps[1] == trsv._UNSPLIT
    chosen = trsv._card_schedule(T, True, np.dtype(np.float64),
                                 torch.device(CPU), lambda d, l: caps)
    costs = {}
    c = 4
    while c < max(widths):
        costs[c] = c
        c *= 2
    costs[trsv._UNSPLIT] = None
    for cap in costs:
        forced = np.array([trsv._UNSPLIT, cap])
        costs[cap] = _cost(trsv._card_schedule(
            T, True, np.dtype(np.float64), torch.device(CPU),
            lambda d, l, f=forced: f), t_level, t_round)
    assert _cost(chosen, t_level, t_round) == pytest.approx(
        min(costs.values()))
    if t_level == 0.0:          # levels are free: the fewest rounds
        assert caps[1] != trsv._UNSPLIT or min(widths) == max(widths)
    if t_level == 1e4:          # levels dominate: no split
        assert caps[1] == trsv._UNSPLIT


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


# p3d64's factors at f64 (the gmres cell's pack): slots and passes a level
P3D64_L0 = (310_972, np.r_[np.full(210, 2), np.full(210, 3)])
P3D64_U0 = (374_654, np.r_[np.full(7, 1), np.full(507, 2)])
P3D64_L1 = (33_282, np.r_[np.full(1006, 1), np.full(64, 2)])
P3D64_U1 = (29_152, np.r_[np.full(971, 1), np.full(85, 2)])


@pytest.mark.parametrize("dtype,width", [(torch.float32, 8),
                                         (torch.float64, 4),
                                         (torch.complex64, 4),
                                         (torch.complex128, 2)])
def test_k2_tile_choice(dtype, width):
    """The column form where x fits in shared memory or the levels are
    narrow; else at one column the split over a cluster, and at several a
    cluster of C blocks a tile of G columns, G up to one 32-byte sector of
    x and C bringing the launch near 64 blocks (the last tile masked)."""
    tile = trsv.trsv_tile
    es = torch.empty((), dtype=dtype).element_size()
    assert width * es == trsv.SECTOR_BYTES
    assert trsv.SPLIT_CTAS in (2, 4, 8)
    fits = trsv.SMEM_BYTES // es - 1
    # the 1M pack's level-0 L: 1,929,216 slots, 377 levels of 5 passes
    big = (1_929_216, np.full(377, 5))
    for nrhs in (1, 2, 7, 8, 64, 128):
        assert tile(fits, np.full(1, 9), es, nrhs) == (1, 1)
    assert tile(fits + 1, np.full(3, 9), es, 1) == (1, trsv.SPLIT_CTAS)
    assert tile(*big, es, 1) == (1, trsv.SPLIT_CTAS)
    # at one column: the split on p3d64's level-0 L and U (2.50 and 1.99
    # passes a level), the column form on its level-1 L and U (1.06, 1.08)
    assert np.mean(P3D64_L0[1]) == 2.5
    assert P3D64_L0[1].size == 420 and P3D64_U0[1].size == 514
    for nslots, passes in (P3D64_L0, P3D64_U0):
        assert trsv.trsv_shape(nslots, 8) == "global"
        assert tile(nslots, passes, es, 1) == (1, trsv.SPLIT_CTAS)
    for nslots, passes in (P3D64_L1, P3D64_U1):
        assert trsv.trsv_shape(nslots, 8) == "global"
        assert np.mean(passes) < 1.1
        assert tile(nslots, passes, es, 1) == (1, 1)
    # at TILE_MIN_PASSES passes a level on the mean and just below it
    at = np.r_[np.full(10, 1), np.full(90, 2)]
    assert np.mean(at) == pytest.approx(trsv.TILE_MIN_PASSES)
    assert tile(10**6, at, es, 1) == (1, trsv.SPLIT_CTAS)
    below = at.copy()
    below[-1] = 1
    assert tile(10**6, below, es, 1) == (1, 1)
    # levels under 1.9 passes of the block on the mean stay on the column
    # form: Stokes' level-1 U on the card schedule (72,964 slots, 3140
    # passes over 1727 levels, 1.82 a level); p3d64's level-0 U (1021
    # passes over 514 levels, 1.99 a level) takes tiles
    stokes = np.r_[np.full(314, 1), np.full(1413, 2)]
    assert stokes.size == 1727 and stokes.sum() == 3140
    assert tile(72_964, stokes, es, 64) == (1, 1)
    assert P3D64_U0[1].sum() == 1021
    assert tile(*P3D64_U0, es, 128) != (1, 1)
    for nrhs in (1, 64):
        assert tile(72_964, np.zeros(0, np.int64), es, nrhs) == (1, 1)
    for nrhs in (2, 7, 8, 16, 32, 64, 128, 256, 1024):
        G, C = tile(*big, es, nrhs)
        assert 2 <= G <= width and G & (G - 1) == 0
        assert G == min(width, max(2, 1 << max(0, (nrhs // 8).bit_length()
                                                - 1)))
        blocks = -(-nrhs // G) * C
        assert C in (1, 2, 4, 8)
        assert blocks <= 64 or C == 1
        assert C == 8 or blocks * 2 > 64
    if width == 8:     # f32: the apply cells' shapes
        assert tile(*big, es, 64) == (8, 8)
        assert tile(*big, es, 128) == (8, 4)
        assert tile(*big, es, 8) == (2, 8)
    assert trsv.trsv_team(4) == 1 and trsv.trsv_team(5) == 2
    assert trsv.trsv_team(69) == 32 and trsv.trsv_team(500) == 32


# trsv_tile's shapes at several columns on the gmres and Stokes cells'
# schedules, pinned: the split at one column must leave every multi-column
# launch as it was
TILE_PINNED = {
    (4, "p3d64_U0"): [(2, 8)] * 4 + [(4, 8), (8, 8), (8, 4)],
    (8, "p3d64_U0"): [(2, 8)] * 4 + [(4, 8), (4, 4), (4, 2)],
    (16, "p3d64_U0"): [(2, 8)] * 4 + [(2, 4), (2, 2), (2, 1)],
}
PINNED_WIDTHS = (2, 7, 8, 16, 32, 64, 128)
PINNED_SCHEDULES = {
    "p3d64_U0": P3D64_U0,
    "stk_U1": (72_964, np.r_[np.full(314, 1), np.full(1413, 2)]),
    "p3d64_L1": P3D64_L1,
}


@pytest.mark.parametrize("itemsize", [4, 8, 16])
@pytest.mark.parametrize("name", list(PINNED_SCHEDULES))
def test_k2_tile_shapes_pinned(itemsize, name):
    want = TILE_PINNED.get((itemsize, name), [(1, 1)] * len(PINNED_WIDTHS))
    nslots, passes = PINNED_SCHEDULES[name]
    assert [trsv.trsv_tile(nslots, passes, itemsize, w)
            for w in PINNED_WIDTHS] == want


@pytest.mark.parametrize("chunk,ring", [(16, True), (6, False)])
def test_k2_ring_needs_whole_lines(chunk, ring):
    """The ring copies a level's (col, val) entries in 16-byte lines: only
    schedules whose levels all start on a line of cols get one (with K 3,
    chunks of 16 slots do, chunks of 6 do not); its width is the widest
    level's entries."""
    T = _port(random_strict_triangular(150, lower=True, nnz_per_row=3,
                                       seed=3))
    s = trsv.build_trsv_schedule(T, lower=True, chunk=chunk, device=CPU)
    assert s.K == 3
    width = trsv._ring_width(s)
    assert (width > 0) == ring
    if ring:
        assert width == 3 * int(np.diff(s.level_slots).max())
