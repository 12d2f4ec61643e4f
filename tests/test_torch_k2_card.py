"""K2 (``csrc/kernels.cu:trsv_solve_kernel``) on the card.

- On the card schedule (:func:`~hifir_tpu_torch.ops.trsv.
  build_trsv_schedule_card`: a K and a split cap a level, no chunk
  padding), in the column and the tile form, f32, f64 and c128, the kernel
  equals its plain version on the same schedule.
- On the uniform reference schedule (:func:`~hifir_tpu_torch.ops.trsv.
  build_trsv_schedule`), the kernel's output is bit-equal to the output of
  K2 before it read a K a level: the SHA-256 of each case's X, taken with
  that kernel on an H100, is in ``data/k2_uniform_digests.json``
  (``python3 tools/probe_k2_schedule.py --digests ROOT`` prints the
  digests of the checkout at ROOT).
- K2's column tiles where x lives in global memory: level 0's L and U of
  poisson2d(512) (host factorize, ``Options(verbose=0)``) on the card
  schedule in f32 and f64, and times seeded unit phases in c64 and c128,
  at 2, 7, 8, 64 and 128 right-hand sides (tiles of 2 to 8 columns,
  clusters of 1 to 8 CTAs, ragged last tiles): the shape rule
  (``trsv.trsv_tile``) gives a tile, the kernel is within 1e-5 (f32, c64)
  / 1e-12 (f64, c128) of the plain version and bit-equal to the column
  form (one block, forced) run on each column alone, one tile launch a
  width and neither a tile nor a split launch for the single columns.  Its phases and right-hand sides are drawn from
  ``default_rng(13)``.
- K2's split (one column on a cluster of 2, 4 or 8 CTAs, each walking its
  share of every level) in f32, f64, c64 and c128: on the same level 0 of
  poisson2d(512) (where ``trsv.trsv_tile`` picks it at one column), on a
  layered triangle whose levels run from 1 to 3000 slots (so that some
  CTAs get empty shares) on the card schedule, and on the same triangle's
  uniform reference schedule of 7-slot chunks and 5 entries a slot
  (levels off the 16-byte lines: no ring), the kernel is bit-equal to the
  column form and within the tile cases' tolerance of the plain version,
  and ``trsv_apply_cuda.split_launches`` counts exactly the split
  launches.
  The layered triangle and its right-hand sides are drawn from
  ``default_rng(14)``.

Every test needs an NVIDIA GPU and skips without one.  On the card:
``python3 -m pytest tests/test_torch_k2_card.py -q --noconftest`` (the
tests' conftest imports JAX).  This file imports no JAX;
:func:`uniform_digests` uses only what the earlier K2 had, so that the
probe can run it there.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hifir_tpu_torch.ds.csr import CSR
from hifir_tpu_torch.ops import trsv

pytestmark = pytest.mark.card

DIGESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "k2_uniform_digests.json")
DTYPES = {"f32": torch.float32, "f64": torch.float64,
          "c128": torch.complex128}
# rows of the large triangle: x outgrows shared memory in every dtype, so
# that the tile form can run
LARGE = 80_000


def triangle(n: int, lower: bool, seed: int, complex_=False) -> CSR:
    """A seeded strict triangle: up to 4 random dependencies a row, and
    every 997th row with up to 300 (so that the card schedule splits some
    levels and widens others); entries of size ~0.3, so the solve stays
    bounded."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 4)
    wide = np.arange(0, n, 997)
    rows = np.concatenate([rows, np.repeat(wide, 300)])
    lim = rows if lower else n - 1 - rows
    keep = lim > 0
    rows, lim = rows[keep], lim[keep]
    off = np.floor(rng.random(rows.size) * lim).astype(np.int64)
    cols = off if lower else rows + 1 + off
    vals = 0.3 * rng.standard_normal(rows.size)
    if complex_:
        vals = vals + 0.3j * rng.standard_normal(rows.size)
    M = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    M.sum_duplicates()
    return CSR.from_scipy(M)


def rhs(n: int, nrhs: int, dt: torch.dtype, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, nrhs))
    if dt.is_complex:
        B = B + 1j * rng.standard_normal((n, nrhs))
    return torch.from_numpy(B).to(dt).cuda()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("K2 runs on an NVIDIA GPU only")


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("n,form", [(3000, "column"), (LARGE, "column"),
                                    (LARGE, "tile")])
def test_k2_card_schedule_equals_plain(dname, lower, n, form):
    _card()
    dt = DTYPES[dname]
    es = torch.empty((), dtype=dt).element_size()
    T = triangle(n, lower, 5, complex_=dt.is_complex)
    S = trsv.build_trsv_schedule_card(T, lower, dtype=np.dtype(
        str(dt).removeprefix("torch.")), device="cuda")
    assert np.all(S.level_K % 4 == 0)
    nrhs = 16 if form == "tile" else 5
    B = rhs(n, nrhs, dt, 7)
    tile, ncta = (trsv.tile_shape(es, nrhs) if form == "tile" else (1, 1))
    if form == "tile":
        assert trsv.trsv_shape(S.nslots, es) == "global"
    X = trsv._trsv_launch(S, B, tile, ncta)
    Xp = trsv.trsv_apply_plain(S, B)
    torch.cuda.synchronize()
    tol = 1e-4 if dt == torch.float32 else 1e-12
    scale = float(Xp.abs().max())
    assert float((X - Xp).abs().max()) <= tol * scale


def uniform_digests() -> dict:
    """``{case: SHA-256 of X}`` of K2 on uniform reference schedules: f32,
    f64 and c128, lower and upper, the column form on a triangle whose x
    fits shared memory and one whose x does not, and the tile form of 2
    columns on clusters of 8 blocks on the latter."""
    out = {}
    for dname, dt in DTYPES.items():
        ndt = np.dtype(str(dt).removeprefix("torch."))
        for lower in (True, False):
            for n, shapes in ((3000, ((1, 1),)), (LARGE, ((1, 1), (2, 8)))):
                T = triangle(n, lower, 5, complex_=dt.is_complex)
                S = trsv.build_trsv_schedule(T, lower=lower, chunk="auto",
                                             dtype=ndt, k_cap="auto",
                                             device="cuda")
                B = rhs(n, 16, dt, 7)
                for tile, ncta in shapes:
                    X = trsv._trsv_launch(S, B, tile, ncta)
                    key = (f"{dname}-{'L' if lower else 'U'}-{n}-"
                           f"{tile}x{ncta}")
                    out[key] = hashlib.sha256(
                        X.cpu().numpy().tobytes()).hexdigest()
    return out


def test_k2_uniform_bit_equal_to_earlier_kernel():
    _card()
    with open(DIGESTS) as f:
        want = json.load(f)
    got = uniform_digests()
    assert got.keys() == want.keys()
    assert [k for k in got if got[k] != want[k]] == []


# K2's tile cases: the operator and the widths (ragged last tiles included)
TILE_NX = 512
TILE_WIDTHS = (2, 7, 8, 64, 128)
TILE_DTYPES = ("float32", "float64", "complex64", "complex128")


@pytest.fixture(scope="module")
def tile_schedules():
    """Level 0's L and U of poisson2d(512) on the card schedule in each
    dtype (the complex factors times seeded unit phases) and their
    right-hand sides, drawn from ``default_rng(13)`` in the order: dtype,
    then L before U, the phases before the block."""
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.models.problems import poisson2d

    _card()
    hp = ht.HIF().factorize(poisson2d(TILE_NX),
                            ht.Options(verbose=0)).precs[0]
    rng = np.random.default_rng(13)
    out = {}
    for dname in TILE_DTYPES:
        dt = getattr(torch, dname)
        for name, Th, lower in (("L", hp.L_B, True), ("U", hp.U_B, False)):
            if dt.is_complex:
                phase = np.exp(2j * np.pi * rng.random(Th.data.size))
                Th = CSR(Th.nrows, Th.ncols, Th.indptr, Th.indices,
                         Th.data * phase)
            S = trsv.build_trsv_schedule_card(
                Th, lower=lower, dtype=np.dtype(dname), device="cuda")
            B = rng.standard_normal((S.n, max(TILE_WIDTHS)))
            if dt.is_complex:
                B = B + 1j * rng.standard_normal((S.n, max(TILE_WIDTHS)))
            out[(dname, name)] = (S, torch.as_tensor(B, dtype=dt,
                                                     device="cuda"))
    return out


@pytest.mark.parametrize("w", TILE_WIDTHS)
@pytest.mark.parametrize("name", ["L", "U"])
@pytest.mark.parametrize("dname", TILE_DTYPES)
def test_k2_tile_form(dname, name, w, tile_schedules):
    _card()
    S, B = tile_schedules[(dname, name)]
    k2 = trsv.trsv_apply_cuda
    es = B.element_size()
    Bw = B[:, :w].contiguous()
    shape = trsv.trsv_tile(S.nslots, S.level_passes, es, w)
    assert shape[0] > 1, (f"the schedule ({S.nslots} slots, {S.nlevels} "
                          f"levels, K {S.K}) takes the column form")
    t0 = k2.tile_launches
    X = trsv.trsv_apply_mrhs(S, Bw)
    tiles = k2.tile_launches - t0
    Xp = trsv.trsv_apply_plain(S, Bw)
    t0, s0 = k2.tile_launches, k2.split_launches
    cols = torch.cat([trsv._trsv_launch(S, Bw[:, j:j + 1].contiguous(), 1, 1)
                      for j in range(w)], 1)
    col_tiles = k2.tile_launches - t0
    col_splits = k2.split_launches - s0
    torch.cuda.synchronize()
    tol = 1e-5 if dname in ("float32", "complex64") else 1e-12
    rel = float((X - Xp).abs().max()) / max(float(Xp.abs().max()), 1e-300)
    assert rel <= tol, f"{rel:.3e} from the plain version"
    assert torch.equal(X, cols), ("the tile form differs from the column "
                                  "form run on each column alone")
    assert (tiles, col_tiles, col_splits) == (1, 0, 0), (tiles, col_tiles,
                                                         col_splits)


# K2's split cases: clusters, and a layered triangle's level widths (the
# narrow ones leave some of a cluster's CTAs with nothing to do)
SPLIT_CTAS = (2, 4, 8)
SPLIT_N = 60_000          # x outgrows shared memory in every dtype
SPLIT_WIDTHS = (1, 5, 17, 40, 63, 64, 65, 129, 500, 3000)


def layered(n: int, lower: bool, rng, complex_: bool) -> CSR:
    """A strict triangle whose dependency levels take SPLIT_WIDTHS rows in
    turn: each row depends on one row of the level before and on up to 3
    earlier rows (every 97th on up to 40), entries of size ~0.3 (~0.05 on
    the wide rows) so that the solve stays bounded."""
    bounds = np.cumsum(np.resize(SPLIT_WIDTHS, n))
    level_of = np.searchsorted(bounds[bounds < n], np.arange(n),
                               side="right")
    start = np.r_[0, bounds][level_of]        # first row of the level
    prev = np.r_[0, 0, bounds][level_of]      # first row of the one before
    rows, cols, vals = [], [], []
    deep = level_of > 0
    r = np.flatnonzero(deep)
    rows.append(r)
    cols.append(prev[r] + np.floor(rng.random(r.size) * (start[r] - prev[r]))
                .astype(np.int64))
    vals.append(0.3 * rng.standard_normal(r.size))
    for extra, scale, step in ((3, 0.3, 1), (40, 0.05, 97)):
        r = np.repeat(np.flatnonzero(deep)[::step], extra)
        rows.append(r)
        cols.append(np.floor(rng.random(r.size) * start[r]).astype(np.int64))
        vals.append(scale * rng.standard_normal(r.size))
    rows, cols, vals = (np.concatenate(a) for a in (rows, cols, vals))
    if complex_:
        vals = vals * np.exp(2j * np.pi * rng.random(vals.size))
    if not lower:
        rows, cols = n - 1 - rows, n - 1 - cols
    M = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    M.sum_duplicates()
    return CSR.from_scipy(M)


@pytest.fixture(scope="module")
def split_schedules(tile_schedules):
    """Each dtype's schedules for the split, and one column each: level 0's
    L and U of poisson2d(512) (``tile_schedules``' first column), and the
    layered triangle on the card schedule and on a uniform reference
    schedule of 7-slot chunks and 5 entries a slot, drawn from
    ``default_rng(14)`` in the order: dtype, then L before U, the triangle
    before the column."""
    rng = np.random.default_rng(14)
    out = {}
    for dname in TILE_DTYPES:
        dt = getattr(torch, dname)
        ndt = np.dtype(dname)
        for name, lower in (("L", True), ("U", False)):
            S, B = tile_schedules[(dname, name)]
            out[(dname, name, "p2d512")] = (S, B[:, :1].contiguous())
            T = layered(SPLIT_N, lower, rng, dt.is_complex)
            b = rng.standard_normal((SPLIT_N, 1))
            if dt.is_complex:
                b = b + 1j * rng.standard_normal((SPLIT_N, 1))
            b = torch.as_tensor(b, dtype=dt, device="cuda")
            out[(dname, name, "layered")] = (trsv.build_trsv_schedule_card(
                T, lower, dtype=ndt, device="cuda"), b)
            out[(dname, name, "noring")] = (trsv.build_trsv_schedule(
                T, lower=lower, chunk=7, dtype=ndt, k_cap=5,
                device="cuda"), b)
    return out


@pytest.mark.parametrize("case", ["p2d512", "layered", "noring"])
@pytest.mark.parametrize("ncta", SPLIT_CTAS)
@pytest.mark.parametrize("name", ["L", "U"])
@pytest.mark.parametrize("dname", TILE_DTYPES)
def test_k2_split_form(dname, name, ncta, case, split_schedules):
    _card()
    S, b = split_schedules[(dname, name, case)]
    k2 = trsv.trsv_apply_cuda
    es = b.element_size()
    assert trsv.trsv_shape(S.nslots, es) == "global"
    widths = np.diff(S.level_slots)
    if case == "p2d512":
        assert trsv.trsv_tile(S.nslots, S.level_passes, es, 1) == \
            (1, trsv.SPLIT_CTAS), "the rule takes the column form"
    elif case == "layered":
        assert widths.min() < ncta * 8 and widths.max() > 2048, (
            "no level leaves a CTA without slots, or none takes two passes")
    else:
        assert trsv._ring_width(S) == 0, "the schedule has a ring"
    t0 = k2.split_launches
    col = trsv._trsv_launch(S, b, 1, 1)
    cols_split = k2.split_launches - t0
    X = trsv._trsv_launch(S, b, 1, ncta)
    split = k2.split_launches - t0 - cols_split
    t0 = k2.split_launches
    Xr = trsv.trsv_apply_mrhs(S, b)
    ruled = k2.split_launches - t0
    Xp = trsv.trsv_apply_plain(S, b)
    torch.cuda.synchronize()
    tol = 1e-5 if dname in ("float32", "complex64") else 1e-12
    rel = float((X - Xp).abs().max()) / max(float(Xp.abs().max()), 1e-300)
    assert torch.isfinite(Xp).all()
    assert rel <= tol, f"{rel:.3e} from the plain version"
    assert torch.equal(X, col), ("the split differs from the column form")
    assert torch.equal(Xr, col)
    picked = trsv.trsv_tile(S.nslots, S.level_passes, es, 1)
    assert (cols_split, split, ruled) == (0, 1, int(picked[1] > 1))
