"""K10b, one ring step of the Schur SpGEMM, on the CPU: the port's plain
version against the JAX kernel, and the tier plan of the CUDA kernel.

``schur_partial`` runs kernel K10b (``csrc/kernels.cu``: a warp a row, a
CTA a row, or a CTA a row on global scratch, by the row's width W = KL *
KU) on CUDA tensors and its plain version on CPU ones.  The kernel runs only
on the card, where ``chip_smoke.py`` holds it against the plain version;
here the plain version is held to the JAX package's ``_partial_kernel``
(jitted on one CPU device with a leading axis of 1, a rank at a time) on
seeded operands packed as the ring packs them, at widths in each tier's
range (1, 225, 512, 513, 1000, 5000, 20000) and on the inputs that break
sorts and scans: long runs of one column (a narrow panel: the runs cross
every lane, warp and tile boundary), rows that are all sentinel, padded
rows (rows not divisible by the ranks).  Columns and masks must be equal
exactly; values within 1e-12 (f64) / 1e-5 (f32) of the JAX kernel's,
relative to their largest entry (the port sums a run in another fixed
order), and within the same of a float64 dense oracle.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifir_tpu.parallel.schur import _partial_kernel

from hifir_tpu_torch.kernels import build
from hifir_tpu_torch.parallel import schur

TOL = {np.float64: 1e-12, np.float32: 1e-5}

# name: (ranks, tail rows nm, U_F rows m, panel width cb, KL, KU, live share)
CASES = {
    "w1": (2, 5, 4, 3, 1, 1, 1.0),
    "w225": (3, 10, 40, 30, 15, 15, 0.8),
    "w512": (2, 6, 60, 40, 32, 16, 0.9),
    "w513": (2, 5, 40, 30, 27, 19, 0.9),
    "w1000": (2, 4, 60, 50, 40, 25, 0.9),
    "w5000": (2, 3, 150, 80, 100, 50, 0.9),
    "w20000": (2, 3, 200, 200, 160, 125, 0.9),
    "long_runs_warp": (2, 7, 120, 2, 100, 2, 1.0),
    "long_runs_block": (2, 5, 400, 3, 300, 3, 1.0),
    "long_runs_global": (2, 3, 4100, 4, 4000, 4, 1.0),
    "all_sentinel": (3, 7, 30, 20, 15, 15, 0.0),
}


def k10b_inputs(rng, D, nm, m, cb, KL, KU, live):
    """Seeded operands as ``schur_spgemm_ring`` packs them: D ranks of nb =
    ceil(nm / D) rows (rows past nm all sentinel, as the padded tail); an
    L_E row holds distinct U_F rows l < m, a binomial share ``live`` of its
    KL slots live, the rest the sentinel m with value 0; a U_F row holds up
    to KU distinct local columns below cb, ascending, the pads cb with value
    0 (row m all pads); d normal + 2, the sentinel's d 0.  Returns numpy
    (le_idx (D, nb, KL), le_val, d (D, m + 1), uf_idx (D, m + 1, KU),
    uf_val), float64."""
    assert KL <= m and KU <= cb
    nb = -(-nm // D)

    def distinct(rows, k, hi):
        # k distinct ascending integers below hi a row: sorted draws in
        # [0, hi - k] plus 0..k-1
        x = np.sort(rng.integers(0, hi - k + 1, size=(rows, k)), axis=1)
        return (x + np.arange(k)).astype(np.int32)

    le_i = np.full((D * nb, KL), m, dtype=np.int32)
    le_v = np.zeros((D * nb, KL))
    take = np.arange(KL) < rng.binomial(KL, live, size=(nm, 1))
    le_i[:nm] = np.where(take, rng.permuted(distinct(nm, KL, m), axis=1), m)
    le_v[:nm] = np.where(take, rng.standard_normal((nm, KL)), 0.0)
    uf_i = np.full((D, m + 1, KU), cb, dtype=np.int32)
    uf_v = np.zeros((D, m + 1, KU))
    keep = np.arange(KU) < rng.integers(0, KU + 1, size=(D * m, 1))
    uf_i[:, :m] = np.where(keep, distinct(D * m, KU, cb), cb).reshape(D, m,
                                                                      KU)
    uf_v[:, :m] = np.where(keep, rng.standard_normal((D * m, KU)),
                           0.0).reshape(D, m, KU)
    d = np.append(rng.standard_normal(m) + 2.0, 0.0)
    return (le_i.reshape(D, nb, KL), le_v.reshape(D, nb, KL),
            np.broadcast_to(d, (D, m + 1)).copy(), uf_i, uf_v)


def dense_oracle(le_i, le_v, d, uf_i, uf_v, cb):
    """The (ranks, nb, cb) product -(L_E D U_F)[rows, panel] in float64 by
    scatter-add, the sentinel column dropped."""
    D, nb, KL = le_i.shape
    out = np.zeros((D, nb, cb + 1))
    for k in range(D):
        ld = le_v[k] * d[k][le_i[k]]                          # (nb, KL)
        cols = uf_i[k][le_i[k]]                               # (nb, KL, KU)
        vals = -(ld[:, :, None] * uf_v[k][le_i[k]])
        rows = np.broadcast_to(np.arange(nb)[:, None, None], cols.shape)
        np.add.at(out[k], (rows, cols), vals)
    return out[:, :, :cb]


@functools.lru_cache(maxsize=None)
def _jax_kernel(cb):
    return jax.jit(functools.partial(_partial_kernel, cb=cb, axis="rows"))


def jax_partial(le_i, le_v, d, uf_i, uf_v, cb):
    """The JAX kernel a rank at a time (a leading axis of 1)."""
    cs, vs = [], []
    for k in range(le_i.shape[0]):
        c, v = _jax_kernel(cb)(*(jnp.asarray(a[k:k + 1]) for a in (
            le_i, le_v)), jnp.asarray(d[k]), jnp.asarray(uf_i[k:k + 1]),
            jnp.asarray(uf_v[k:k + 1]))
        cs.append(np.asarray(c[0]))
        vs.append(np.asarray(v[0]))
    return np.stack(cs), np.stack(vs)


def _case(name, dtype):
    D, nm, m, cb, KL, KU, live = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    le_i, le_v, d, uf_i, uf_v = k10b_inputs(rng, D, nm, m, cb, KL, KU, live)
    return (le_i, le_v.astype(dtype), d.astype(dtype), uf_i,
            uf_v.astype(dtype)), cb


def _rel(x, ref) -> float:
    return (float(np.abs(x - ref).max(initial=0))
            / max(float(np.abs(ref).max(initial=0)), 1e-300))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_kernel(name, dtype):
    args, cb = _case(name, dtype)
    calls = schur.schur_partial_plain.calls
    pc, pv = schur.schur_partial(*(torch.from_numpy(a) for a in args), cb)
    assert schur.schur_partial_plain.calls == calls + 1
    D, nb, KL = args[0].shape
    W = KL * args[3].shape[2]
    assert pc.shape == pv.shape == (D, nb, W) and pc.dtype == torch.int32
    assert pv.dtype == torch.from_numpy(args[1]).dtype
    jc, jv = jax_partial(*args, cb)
    np.testing.assert_array_equal(pc.numpy(), jc)
    assert _rel(pv.numpy(), jv) <= TOL[dtype]
    # a run's sum sits at its last position, every other position is (cb, 0)
    masked = pc.numpy() == cb
    assert not pv.numpy()[masked].any()
    if name == "all_sentinel":
        assert masked.all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_equals_dense_oracle(name, dtype):
    """Each column of a row appears at most once, at the last position of
    its sorted run, with the run's sum: scattered back they give the dense
    product."""
    args, cb = _case(name, dtype)
    pc, pv = (t.numpy() for t in schur.schur_partial(
        *(torch.from_numpy(a) for a in args), cb))
    D, nb, W = pc.shape
    live = pc < cb
    got = np.zeros((D, nb, cb + 1))
    seen = np.zeros((D, nb, cb + 1), dtype=np.int64)
    k, r, w = np.nonzero(live)
    np.add.at(seen, (k, r, pc[k, r, w]), 1)
    assert seen.max(initial=0) <= 1
    got[k, r, pc[k, r, w]] = pv[k, r, w]
    ref = dense_oracle(*(a.astype(np.float64) if a.dtype.kind == "f" else a
                         for a in args), cb)
    assert _rel(got[:, :, :cb], ref) <= TOL[dtype]


@pytest.mark.parametrize("W, tier, P", [
    (1, "warp", 32), (32, "warp", 32), (33, "warp", 64), (225, "warp", 256),
    (512, "warp", 512), (513, "block", 1024), (1000, "block", 1024),
    (4096, "block", 4096), (5000, "block", 8192), (8192, "block", 8192),
    (8193, "global", 16384), (20000, "global", 32768),
    (1 << 24, "global", 1 << 24)])
def test_tier_plan(W, tier, P):
    """The tier is chosen once a launch from W; no width is refused."""
    rows, sms = 4088, 132
    plan = schur.schur_plan(W, rows, 8, sms, 511)
    assert (plan["tier"], plan["P"]) == (tier, P)
    assert plan["grid"] == {"warp": -(-rows // 8), "block": rows,
                            "global": 2 * sms}[tier]
    assert plan["scratch"] == (plan["grid"] * P * 12 if tier == "global"
                               else 0)


def test_tier_plan_forced():
    """A forced tier pads W to its least width; a width beyond a forced
    tier's range raises."""
    assert schur.schur_plan(225, 10, 4, 132, 30, "block")["P"] == 512
    plan = schur.schur_plan(225, 10, 4, 132, 30, "global")
    assert (plan["P"], plan["grid"], plan["scratch"]) == (16384, 10,
                                                          10 * 16384 * 8)
    with pytest.raises(ValueError, match="does not fit the warp tier"):
        schur.schur_plan(600, 10, 8, 132, 30, "warp")
    with pytest.raises(ValueError, match="tier 'lane'"):
        schur.schur_plan(10, 10, 8, 132, 30, "lane")


@pytest.mark.parametrize("W, cb, tier", [
    (225, 2**23 - 2, "warp"), (225, 2**23 - 1, "block"),
    (32, 2**26 - 2, "warp"), (32, 2**26 - 1, "block"),
    (512, 2**22 - 2, "warp"), (512, 2**22 - 1, "block")])
def test_tier_plan_packs_below_2_31(W, cb, tier):
    """The warp tier sorts (column * P + position) in one int: a panel too
    wide to pack takes the block tier, which moves columns and values."""
    assert schur.schur_plan(W, 4088, 8, 132, cb)["tier"] == tier


@pytest.fixture
def no_compiler(monkeypatch):
    """Loading the library or asking for nvcc fails the test."""
    def refuse(*a, **k):
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(build, "load_kernels", refuse)
    monkeypatch.setattr(build, "nvcc_path", refuse)


def test_cuda_wrapper_takes_any_width(no_compiler):
    """A row of 20000 candidates (beyond the first kernel's shared-memory
    limit of 16384) is planned, not refused: a CPU tensor fails only at the
    device check, before the library is loaded."""
    args, cb = _case("w20000", np.float64)
    launches = schur.schur_partial_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        schur.schur_partial_cuda(*(torch.from_numpy(a) for a in args), cb)
    assert schur.schur_partial_cuda.launches == launches


def test_build_lists_schur_real_only():
    assert build.SUFFIXES["schur_partial"] == ("f32", "f64")
    # le_idx, le_val, d, its stride, uf_idx, uf_val, their stride, rows,
    # nb, KL, KU, cb, the tier, P, the grid, the scratch, the outputs and
    # the stream
    assert len(build._SIGNATURES["schur_partial"]) == 19
