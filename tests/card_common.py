"""What the card tests (``tests/test_torch_*_card.py``) and the probes in
``tools/`` share: fixtures' paths and options, the launch counters, the
seeded inputs of each area in the order they are drawn, and the checks of
the distributed chunk loops.

Each area draws from its own generator, ``np.random.default_rng(offset)``
(see ``SEED``), in one fixed order; the ``*_draws`` functions below make
those draws from shapes alone, so that a test run alone (``-k``) gets the
same inputs as one run with its whole file.

This module imports neither JAX nor ``hifir_tpu``: the card machine has
neither.  ``tools/`` reaches it with ``tests/`` on ``sys.path``.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "benchdata", "frozen_prec.npz")
CONVDIFF = os.path.join(ROOT, "hifir_tpu_torch", "data",
                        "convdiff2d_128_prec.npz")
CONVDIFF_C = os.path.join(ROOT, "hifir_tpu_torch", "data",
                          "convdiff2d_128_c_prec.npz")
NRHS = 128
# each area's generator: np.random.default_rng(SEED[area])
SEED = dict(main=0, surface=1, complex=2, factorize=3, million=4, saddle=5,
            dist=6, k10b=7, paths=8, poisson3d=9, multicard=10, graphs=11,
            dist_graphs=12, k2_tiles=13)
# options of the checked-in nonsymmetric fixture (the command that wrote it
# is in tests/test_torch_surface.py) and of the JAX distribution tests
FIXTURE_OPTS = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=3,
                    kappa_d=3, dense_thres=600, verbose=0)
RED_OPTS = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5,
                kappa_d=5, verbose=0, dense_thres=50)
DIST_NX = 512          # the JAX package's DistPrec scale leg
DIST_CHUNK = 1024
DIST_RANKS = 8
SWEEP_WIDE_RANKS = (16, 17, 32)
# replayed calls behind each launch-counter gate of a graph cell
GRAPH_REPS = 5
# seconds a test waits for the cards before the process ends: a peer sweep
# whose flags never come would spin (the kernel traps after 30 s of one
# wait, kernels.cu:kPeerWaitNs), so no wait blocks for ever
WAIT_DEADLINE_S = 120.0


def skip_without_card(cards: int = 1) -> None:
    """Skip the calling fixture or test unless the machine has ``cards``
    NVIDIA GPUs.  Called at run time, never while a module is imported, so
    that every pytest worker collects the same tests."""
    import pytest

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < cards:
        pytest.skip("needs an NVIDIA GPU" if cards == 1 else
                    f"needs {cards} cards or more; the machine has {n}")


def rel_diff(Y, ref) -> float:
    return float((Y - ref).abs().max()) / max(float(ref.abs().max()), 1e-300)


def host_rel(X, ref) -> float:
    """max|X - ref| / max|ref| with X a tensor and ref a host array."""
    X = X.cpu().resolve_conj().numpy() if torch.is_tensor(X) else X
    ref = ref.cpu().resolve_conj().numpy() if torch.is_tensor(ref) else ref
    X, ref = np.asarray(X, np.complex128), np.asarray(ref, np.complex128)
    return float(np.abs(X - ref).max() / np.abs(ref).max())


def case_id(case) -> str:
    """A test id of a tuple case: its parts joined by "-", no spaces."""
    return "-".join(str(x) for x in case).replace(" ", "_")


def draw(rng, shapes, cplx=False) -> list:
    """``rng.standard_normal`` of each shape in turn (a complex draw takes
    the real part, then the imaginary part)."""
    out = []
    for s in shapes:
        a = rng.standard_normal(s)
        out.append(a + 1j * rng.standard_normal(s) if cplx else a)
    return out


# ---------------------------------------------------------------------------
# launch counters

def counters() -> dict:
    from hifir_tpu_torch.ops import bsr_spmv, spmv, trsv

    return {"K7": bsr_spmv.bsr_spmv_cuda, "K1": spmv.sell_spmv_cuda,
            "K2": trsv.trsv_apply_cuda}


def dist_counters() -> dict:
    from hifir_tpu_torch.ops import chunk
    from hifir_tpu_torch.parallel import schur

    return {"K10a": chunk.ChunkSweep, "sweep": chunk.ChunkSweepKernel,
            "peer": chunk.PeerSweepKernel, "K10b": schur.schur_partial_cuda}


def reset_counts() -> None:
    for f in counters().values():
        f.launches = 0
    counters()["K1"].plus_launches = 0


def read_counts() -> dict:
    out = {k: f.launches for k, f in counters().items()}
    out["K1plus"] = counters()["K1"].plus_launches
    return out


def plain_calls() -> int:
    """Calls of the plain kernel versions so far."""
    from hifir_tpu_torch.ops import bsr_spmv, spmv, trsv

    return (spmv.sliced_ell_sub_mrhs_plain.calls
            + trsv.trsv_apply_plain.calls
            + bsr_spmv.bsr_matvec_mrhs_plain.calls)


def counted(fn):
    """``fn()`` with the launch counts set to 0 just before it and read just
    after; returns its result, the counts and the plain versions' calls."""
    torch.cuda.synchronize()
    reset_counts()
    p0 = plain_calls()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts(), plain_calls() - p0


def want_launches(forms) -> dict:
    """The launches one M-solve must make on a pack whose levels' operands
    are ``forms``, (L, U, E, F) per level (forward, or the adjoint's
    (L^H, U^H, F^H, E^H)): K2 once per triangular solve on a schedule, L and
    U of every such level once down and once up; K1 once per operator with
    entries, E on the way down, F on the way up, and every Off_b of a
    blocked inverse, whose L and U run once down and once up."""
    from hifir_tpu_torch.ops.trsv import TrsvBlockDense, TrsvSchedule

    k2 = 2 * sum(isinstance(f, TrsvSchedule) and f.nchunks > 0
                 for L, U, _, _ in forms for f in (L, U))
    k1 = sum((E.nnz > 0) + (F.nnz > 0) for _, _, E, F in forms)
    k1 += 2 * sum(o.nnz > 0 for L, U, _, _ in forms for f in (L, U)
                  if isinstance(f, TrsvBlockDense) for o in f.offs)
    return {"K1": k1, "K2": k2}


def solve_forms(dp, trans: bool) -> list:
    """(L, U, E, F) of each level of pack ``dp`` as one M-solve runs them."""
    if trans:
        return [(t.LT, t.UT, t.FT, t.ET) for t in dp.tran]
    return [(lv.L, lv.U, lv.E, lv.F) for lv in dp.levels]


# ---------------------------------------------------------------------------
# the seeded inputs of the kernel rows, the main path and the complex rows

def kernel_cases():
    """The kernel rows on the frozen fixture and the nonsymmetric one, in
    the order they draw: (dtype, row, nrhs).  "K7 read" draws a block that
    no test reads (it fed a timing)."""
    out = []
    for dname in ("float32", "float64"):
        out += [(dname, "K7", n) for n in (NRHS, 8, 1)]
        out += [(dname, "K7 paths", n) for n in (1, 2, 4)]
        out.append((dname, "K7 read", 1))
        for nm in ("E", "F"):
            out += [(dname, f"K1 {nm} in-place", n) for n in (NRHS, 8, 1)]
            out.append((dname, f"K1 {nm} product", NRHS))
        for nm in ("Loff", "Uoff"):
            out += [(dname, f"K1 {nm}", n) for n in (NRHS, 1)]
        out += [(dname, "K1 Uplus", n) for n in (NRHS, 1)]
        out.append((dname, "K1 ell E", NRHS))
        for li in (0, 1):
            for nm in ("L", "U"):
                out += [(dname, f"K2 {nm}{li}", n) for n in (NRHS, 1)]
    return out


# the blocked inverse's Off_b rows: (host factor, lower, block); an Off_b
# is a W x (blocks * W) operator (ops/trsv.py:build_trsv_block_dense)
BLOCK_W = 2048
OFF_ROWS = {"Loff": ("L_B", True, 6), "Uoff": ("U_B", False, 4)}


def kernel_shapes(case, M, Mc) -> list:
    """The shapes ``case`` draws, X then C (in place and out of place) for
    K1, X for K7, B for K2."""
    _, row, nrhs = case
    h0 = M.precs[0]
    if row.startswith("K7"):
        n = -(-h0.n // 128) * 128     # poisson2d(128) as BSR, bs = 128
        return [(n, nrhs)]
    if row.startswith("K2"):
        return [(M.precs[int(row[-1])].m, nrhs)]
    if row == "K1 ell E":
        return [(h0.E.ncols, nrhs)]
    if row == "K1 Uplus":
        U = Mc.precs[0].U_B
        return [(U.ncols, nrhs), (U.nrows, nrhs)]
    if row in ("K1 Loff", "K1 Uoff"):
        npad = -(-h0.m // BLOCK_W) * BLOCK_W
        return [(npad, nrhs), (BLOCK_W, nrhs)]
    E = h0.E if row.startswith("K1 E") else h0.F
    if row.endswith("product"):
        return [(E.ncols, nrhs)]
    return [(E.ncols, nrhs), (E.nrows, nrhs)]


def kernel_draws(M, Mc):
    """The kernel rows' inputs ({case: arrays}) and the generator after
    them, which the main path draws from next."""
    rng = np.random.default_rng(SEED["main"])
    out = {c: draw(rng, kernel_shapes(c, M, Mc)) for c in kernel_cases()}
    return out, rng


def main_rhs(M, Mc) -> np.ndarray:
    """The main path's 128 right-hand sides (after the kernel rows')."""
    return kernel_draws(M, Mc)[1].standard_normal((M.precs[0].n, NRHS))


CPLX = ("complex64", "complex128")


def complex_cases():
    """The complex kernel rows, in the order they draw: (dtype, row, nrhs)."""
    out = []
    for dname in CPLX:
        out += [(dname, "K1 E in-place", n) for n in (NRHS, 8, 1)]
        out.append((dname, "K1 Uplus", NRHS))
        out += [(dname, "K2 L0", n) for n in (NRHS, 1)]
    return out


def complex_draws(Mz):
    """The complex area's right-hand sides B, its kernel rows' inputs and
    the generator after them (the adjoint identity's Y comes next)."""
    rng = np.random.default_rng(SEED["complex"])
    n = Mz.precs[0].n
    B = draw(rng, [(n, NRHS)], cplx=True)[0]
    rows = {c: draw(rng, kernel_shapes(c, Mz, Mz), cplx=True)
            for c in complex_cases()}
    return B, rows, rng


# ---------------------------------------------------------------------------
# the distribution: counters, waits and the chunk loops' checks

def dist_reset() -> None:
    reset_counts()
    for f in dist_counters().values():
        f.launches = 0


def dist_read() -> dict:
    out = {k: f.launches for k, f in counters().items()}
    out.update({k: f.launches for k, f in dist_counters().items()})
    return out


def dist_count(fn):
    """``fn()`` with every launch count (K10a, the sweeps and K10b too) set
    to 0 just before it and read just after, every card waited for; a call
    of a plain version on the card fails.  Returns the result and the
    counts."""
    from hifir_tpu_torch.ops import chunk, spmv, trsv
    from hifir_tpu_torch.ops.bsr_spmv import bsr_matvec_mrhs_plain
    from hifir_tpu_torch.parallel import schur

    plains = (chunk.chunk_fma_plain, chunk.chunk_sweep_plain,
              chunk.chunk_sweep_peer_plain, schur.schur_partial_plain,
              spmv.sliced_ell_sub_mrhs_plain, trsv.trsv_apply_plain,
              bsr_matvec_mrhs_plain)
    for f in plains:
        f.calls = 0
    sync_all()
    dist_reset()
    out = fn()
    sync_all()
    counts = dist_read()
    plain = sum(f.calls for f in plains)
    assert plain == 0, f"{plain} plain-version calls on the card"
    return out, counts


def sync_all() -> None:
    """Wait for every card (a mesh may span several): an event on each
    card's current stream, polled with ``query()`` for at most
    ``WAIT_DEADLINE_S`` seconds; past it the process ends at once (exit 3),
    never blocking on a card that does not finish.  Then each card is
    synchronised, which raises a kernel's error."""
    evs = []
    for i in range(torch.cuda.device_count()):
        with torch.cuda.device(i):
            e = torch.cuda.Event()
            e.record()
            evs.append(e)
    t0 = time.perf_counter()
    while not all(e.query() for e in evs):
        if time.perf_counter() - t0 > WAIT_DEADLINE_S:
            print(f"the cards did not finish within {WAIT_DEADLINE_S} s "
                  "(a peer sweep's waits did not pass)", flush=True)
            sys.stderr.flush()
            os._exit(3)
        time.sleep(1e-4)
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def dist_solve_factors(dp) -> dict:
    """What carries each factor of a DistPrec and the chunks of one solve
    (each factor runs twice, down and up)."""
    from hifir_tpu_torch.parallel.trsv_halo import HaloOp

    ops = [op for lv in dp.levels for op in (lv.L_op, lv.U_op)
           if op.nchunks]
    kinds = [type(op).__name__ for op in ops]
    return dict(factors=len(kinds), halo_factors=kinds.count(HaloOp.__name__),
                forms=sorted({op.plan.form for op in ops}),
                ag_factors=kinds.count("AGTrsvOp"),
                chunks_per_solve=2 * sum(op.nchunks for lv in dp.levels
                                         for op in (lv.L_op, lv.U_op)),
                xin_levels=sum(lv.xin is not None for lv in dp.levels))


def sweep_gates(per: dict, shape: dict, what: str) -> None:
    """On the one-group mesh every factor application is one sweep launch
    (each factor with chunks runs twice a solve, down and up) and no K10a
    launch runs."""
    assert (per["sweep"] == 2 * shape["factors"] and per["K10a"] == 0
            and per["peer"] == 0 and shape["forms"] == ["sweep"]), (
        f"{what}: {per['sweep']} sweep launches for {shape['factors']} "
        f"factors with chunks, {per['K10a']} K10a launches, "
        f"{per['peer']} peer sweeps, forms {shape['forms']}")


def k10a_gates(per: dict, shape: dict, ngroups: int, what: str) -> None:
    """On a mesh of several groups without peer access every chunk step is
    one K10a launch a group and no sweep runs."""
    assert (per["K10a"] == ngroups * shape["chunks_per_solve"]
            and per["sweep"] == 0 and per["peer"] == 0
            and shape["forms"] == ["chunk"]), (
        f"{what}: {per['K10a']} K10a launches, {per['sweep']} sweeps, "
        f"{per['peer']} peer sweeps for {shape['chunks_per_solve']} chunk "
        f"steps of {ngroups} groups, forms {shape['forms']}")


def peer_gates(per: dict, shape: dict, ncards: int, what: str) -> None:
    """On a mesh of several groups whose devices reach each other's memory
    every factor application is one peer-sweep launch a card (the groups
    of a card are the clusters of its launch) and no K10a launch or
    one-group sweep runs."""
    assert (per["peer"] == ncards * 2 * shape["factors"]
            and per["K10a"] == 0 and per["sweep"] == 0
            and shape["forms"] == ["peer"]), (
        f"{what}: {per['peer']} peer-sweep launches for "
        f"{shape['factors']} factors with chunks on {ncards} cards, "
        f"{per['K10a']} K10a launches, {per['sweep']} sweeps, forms "
        f"{shape['forms']}")


def own_slots(op) -> int:
    """The slots of a factor's slot vector that hold its own rows."""
    from hifir_tpu_torch.parallel.trsv_halo import HaloOp

    return op.own_len if isinstance(op, HaloOp) else op.nslots


def sweep_pair(rng, op, dt, values=None):
    """One application of factor ``op``'s chunk sweep (its one-group plan)
    by the kernel and by ``chunk_sweep_plain`` on the same slot vectors:
    random own slots (drawn from ``rng``, or ``values``), the halo regions
    and the zero slot zero.  Returns the sweep, the entry vectors and both
    results."""
    from hifir_tpu_torch.ops import chunk

    assert op.plan.form == "sweep", (
        f"the factor's loop is {op.plan.form}, not the one-group sweep")
    sw = op.plan.sweeps[0]
    own = own_slots(op)
    if values is None:
        values = rng.standard_normal((sw.ranks, own))
    x0 = torch.zeros((sw.ranks, sw.min_len), dtype=dt, device=sw.vals.device)
    x0[:, :own] = torch.as_tensor(values, dtype=dt, device=x0.device)
    xk, xp = x0.clone(), x0.clone()
    chunk.chunk_sweep(xk, sw)
    chunk.chunk_sweep_plain(xp, sw)
    torch.cuda.synchronize()
    return sw, x0, xk, xp


def peer_pair(rng, op, dt, values=None):
    """One application of factor ``op``'s peer sweep by the kernel and by
    ``chunk_sweep_peer_plain`` on the same slot vectors (per group: random
    own slots, drawn from ``rng`` or taken from ``values``, the halo
    regions and the zero slot zero).  Returns the plan, the entry vectors
    and both results, each as the groups' rows stacked on the first
    group's card."""
    from hifir_tpu_torch.ops import chunk

    plan = op.plan
    assert plan.form == "peer", (
        f"the factor's loop is {plan.form}, not the peer sweep")
    own = own_slots(op)
    if values is None:
        values = [rng.standard_normal((sw.ranks, own)) for sw in plan.sweeps]
    x0 = []
    for sw, v in zip(plan.sweeps, values, strict=True):
        x = torch.zeros((sw.ranks, sw.min_len), dtype=dt,
                        device=sw.vals.device)
        x[:, :own] = torch.as_tensor(v, dtype=dt, device=x.device)
        x0.append(x)
    xk = [x.clone() for x in x0]
    xp = [x.clone() for x in x0]
    chunk.chunk_sweep_peer(xk, plan)
    chunk.chunk_sweep_peer_plain(xp, plan)
    sync_all()
    dev = x0[0].device
    stack = lambda xs: torch.cat([x.to(dev) for x in xs])  # noqa: E731
    return plan, x0, stack(xk), stack(xp)


def pair_shapes(op) -> list:
    """The shapes :func:`sweep_pair` / :func:`peer_pair` draw for ``op``."""
    return [(sw.ranks, own_slots(op)) for sw in op.plan.sweeps]


# K10b beside the convdiff2d(128) level-0 shape (warp tier): one seeded
# shape in each wider tier, and the inputs that break sorts and scans, each
# through every tier whose range holds it.  (name, ranks, tail rows nm, U_F
# rows m, panel width cb, KL, KU, live share); W = KL * KU.
K10B_SHAPES = (("block", 8, 512, 4096, 512, 64, 64, 0.9),
               ("global", 8, 256, 4000, 1000, 160, 125, 0.9))
K10B_EDGES = (("w1", 8, 13, 4, 3, 1, 1, 1.0),
              ("w225", 8, 61, 40, 30, 15, 15, 0.8),
              ("w512", 8, 29, 60, 40, 32, 16, 0.9),
              ("w513", 8, 29, 40, 30, 27, 19, 0.9),
              ("long runs w200", 8, 61, 120, 2, 100, 2, 1.0),
              ("long runs w900", 8, 37, 400, 3, 300, 3, 1.0),
              ("long runs w16000", 8, 19, 4100, 4, 4000, 4, 1.0),
              ("all sentinel", 8, 61, 40, 30, 15, 15, 0.0))
K10B_TOL = {"float64": 1e-12, "float32": 1e-5}


def k10b_inputs(rng, D, nm, m, cb, KL, KU, live):
    """Seeded K10b operands as ``schur_spgemm_ring`` packs them (numpy,
    float64): D ranks of nb = ceil(nm / D) rows (rows past nm all sentinel,
    as the padded tail); an L_E row holds distinct U_F rows l < m, a
    binomial share ``live`` of its KL slots live, the rest the sentinel m
    with value 0; a U_F row up to KU distinct local columns below cb,
    ascending, pads cb with value 0 (row m all pads); d normal + 2, the
    sentinel's d 0.  (The CPU tests' generator,
    tests/test_torch_schur_kernel.py.)"""
    nb = -(-nm // D)

    def distinct(rows, k, hi):
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
    uf_i[:, :m] = np.where(keep, distinct(D * m, KU, cb),
                           cb).reshape(D, m, KU)
    uf_v[:, :m] = np.where(keep, rng.standard_normal((D * m, KU)),
                           0.0).reshape(D, m, KU)
    d = np.append(rng.standard_normal(m) + 2.0, 0.0)
    return (le_i.reshape(D, nb, KL), le_v.reshape(D, nb, KL),
            np.broadcast_to(d, (D, m + 1)), uf_i, uf_v)


def k10b_run(ops, cb, dt, what, tier=None):
    """K10b on numpy operands ``ops`` (le_idx, le_val, d, uf_idx, uf_val)
    in ``dt`` on the card, in ``tier`` (default: the plan's), against the
    plain version: columns and masks equal, values within K10B_TOL of the
    plain version's largest; a second launch bitwise equal to the first.
    Returns (card args, the plan, the values' relative difference)."""
    from hifir_tpu_torch.parallel import schur

    t = lambda a, v=None: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a), dtype=v, device="cuda")
    args = (t(ops[0]), t(ops[1], dt), t(ops[2], dt), t(ops[3]),
            t(ops[4], dt))
    D, nb, KL = ops[0].shape
    W = KL * ops[3].shape[2]
    plan = schur.schur_plan(W, D * nb, args[1].element_size(),
                            torch.cuda.get_device_properties(0)
                            .multi_processor_count, cb, tier)
    kc, kv = schur.schur_partial_cuda(*args, cb, tier=tier)
    kc2, kv2 = schur.schur_partial_cuda(*args, cb, tier=tier)
    pc, pv = schur.schur_partial_plain(*args, cb)
    torch.cuda.synchronize()
    dname = str(dt).removeprefix("torch.")
    where = f"K10b {what} {dname} ({plan['tier']} tier)"
    bits = torch.int64 if dt == torch.float64 else torch.int32
    assert torch.equal(kc, kc2) and torch.equal(kv.view(bits),
                                                kv2.view(bits)), (
        f"{where}: two launches differ")
    assert torch.equal(kc, pc), (
        f"{where}: the kernel's columns and masks differ from the plain "
        "version's")
    rel = rel_diff(kv, pv)
    assert rel <= K10B_TOL[dname], (
        f"{where}: values {rel:.3e} from the plain version's")
    return args, plan, rel


# ---------------------------------------------------------------------------
# K8's comparison with its plain version

def qr_dist(F, Fref, m: int):
    """Q[:, :m] and R[:m] of factorization F = (Q, R, piv) against Fref's,
    each reflector's sign taken from R's diagonal (a zero counts as +) and
    R's rows put back in the original column order (R P^T = Q^T A, so rows
    below m compare whatever the later pivots): Q's largest difference and
    R's, each relative to Fref's largest entry, and the largest absolute
    difference of the two."""
    if m == 0:
        return 0.0, 0.0, 0.0

    def normal(Q, R, piv):
        s = torch.where(R.diagonal()[:m] < 0, -1.0, 1.0).double()
        Ro = torch.empty((m, R.shape[1]), dtype=torch.float64,
                         device=R.device)
        Ro[:, piv] = R[:m].double() * s[:, None]
        return Q[:, :m].double() * s, Ro

    (q, r), (qr, rr) = normal(*F), normal(*Fref)
    dq, dr = float((q - qr).abs().max()), float((r - rr).abs().max())
    return (dq / max(float(Fref[0].abs().max()), 1e-300),
            dr / max(float(Fref[1].abs().max()), 1e-300), max(dq, dr))


def first_diff(a, b, m: int) -> int:
    """The first position below m where pivot vectors a and b differ (m if
    none)."""
    d = np.flatnonzero(a[:m] != b[:m])
    return int(d[0]) if d.size else m


# ---------------------------------------------------------------------------
# the graph layer

@contextlib.contextmanager
def replays_without_sync():
    """Every graph replay inside runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a synchronising call in a
    replay raises.  Each replay is counted in the yielded list."""
    from hifir_tpu_torch import graphs

    orig, seen = graphs.CudaGraphs.replay, []

    def replay(self, graph):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            orig(self, graph)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        seen.append(1)

    graphs.CudaGraphs.replay = replay
    try:
        yield seen
    finally:
        graphs.CudaGraphs.replay = orig


def host_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its result
    and the number of synchronising calls it made (the mode's warnings)."""
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, sum("synchronizing CUDA operation" in str(w.message)
                    for w in caught)


def same(a, b) -> bool:
    """Bit-equal results (a tensor, or a tuple of them)."""
    if isinstance(a, tuple):
        return all(same(x, y) for x, y in zip(a, b, strict=True))
    return bool(a.device == b.device and torch.equal(a, b))


def dist_graph_cell(owner, run, ref=None, tol=None) -> dict:
    """One distributed program on ``owner`` (a DistPrec or a mesh): ``run()``
    eagerly (``owner.graphs`` off) and as a replay of its captured graph.
    The replay equals the eager run bit for bit (and, given ``ref``, its
    host or plain reference within ``tol``); no replay synchronises
    (:func:`replays_without_sync`); ``GRAPH_REPS`` calls count
    ``GRAPH_REPS`` times one eager call's K1, K2, K7, K10a, sweep, peer and
    K10b launches.  Every wait has the deadline.  Returns the launches of
    the replayed calls."""
    owner.graphs = False
    sync_all()
    dist_reset()
    Xe = run()
    sync_all()
    eager = dist_read()
    owner.graphs, owner.graph_cache = True, None
    run()
    sync_all()
    with replays_without_sync() as seen:
        Xr = run()
        dist_reset()
        for _ in range(GRAPH_REPS):
            run()
    sync_all()
    got = dist_read()
    if ref is not None:
        Y = Xr[0] if isinstance(Xr, tuple) else Xr
        err = rel_diff(Y.double(), ref.to(Y.device))
        assert err <= tol, f"replay vs reference {err:.3e} > {tol}"
    assert same(Xr, Xe), "the replay differs from the eager run"
    assert len(seen) == 1 + GRAPH_REPS, (
        f"{len(seen)} replays for {1 + GRAPH_REPS} calls of one program")
    for k, c in eager.items():
        assert got[k] == GRAPH_REPS * c, (
            f"{got[k]} {k} launches in {GRAPH_REPS} replayed calls, one "
            f"eager call {c}")
    return got


# ---------------------------------------------------------------------------
# the distribution's operators and inputs (default_rng(6))

def dist_world():
    """The operators of the distribution's checks on eight ranks of one
    card and every input they draw from ``default_rng(6)``, in its order.

    poisson2d(512) (the JAX package's DistPrec scale leg, robust options)
    with its DistPrec in f64 and f32 on one group (``dps``), on two groups
    of the card in the chunk form (``dps2``, eager) and the peer form
    (``dps_peer``, halo and all_gather); poisson2d(64) with the JAX
    distribution tests' options (chunk 64) on one group (halo, all_gather,
    whole vectors), two groups (chunk and peer forms) and 16, 17 and 32
    ranks; the (2, 4) mesh with A sharded by rows; convdiff2d(128) on the
    anchors with the host Schur (``Ph``).  ``draws`` holds the inputs by
    the part that reads them."""
    import types

    import hifir_tpu_torch as ht
    from hifir_tpu_torch.models.problems import convdiff2d, poisson2d
    from hifir_tpu_torch.parallel import DistPrec, make_mesh, shard_ell_rows
    from hifir_tpu_torch.parallel.prec_sharded import AGTrsvOp
    from hifir_tpu_torch.parallel.trsv_halo import HaloOp

    w = types.SimpleNamespace(draws={})
    d = w.draws
    rng = np.random.default_rng(SEED["dist"])
    w.mesh = make_mesh(DIST_RANKS, device="cuda")
    # "cuda:0" and "cuda" are distinct devices to the mesh: two groups of
    # four ranks on the one card
    w.mesh2 = make_mesh(devices=["cuda:0"] * 4 + ["cuda"] * 4)
    w.A = poisson2d(DIST_NX)
    w.P = ht.HIF().factorize(w.A, ht.Options(verbose=0), device="cuda")
    d["b"] = w.b = rng.standard_normal(w.A.nrows)
    w.xh = w.P.solve(w.b)
    w.single = w.P.to_device(dtype=np.float64, device="cuda")
    kw = dict(chunk=DIST_CHUNK, max_halo_chunks=128)
    w.dps, w.dps2, w.dps_peer = {}, {}, {}
    for dt in ("float64", "float32"):
        w.dps[dt] = DistPrec.from_host(w.mesh, w.P, dtype=np.dtype(dt), **kw)
        w.dps2[dt] = DistPrec.from_host(w.mesh2, w.P, dtype=np.dtype(dt),
                                        form="chunk", graphs=False, **kw)
        for form in ("halo", "all_gather"):
            w.dps_peer[(dt, form)] = DistPrec.from_host(
                w.mesh2, w.P, dtype=np.dtype(dt), halo=form == "halo", **kw)

    w.P64 = ht.HIF().factorize(poisson2d(64), ht.Options(**RED_OPTS),
                               device="cuda")
    d["b64"] = w.b64 = rng.standard_normal(w.P64.precs[0].n)
    w.xh64 = w.P64.solve(w.b64)
    forms = {"halo": {}, "all_gather": dict(halo=False),
             "whole vectors": dict(shard_vectors=False)}
    w.p64 = {form: DistPrec.from_host(w.mesh, w.P64, chunk=64, **f)
             for form, f in forms.items()}
    w.p64_chunk = {form: DistPrec.from_host(w.mesh2, w.P64, chunk=64,
                                            form="chunk", **forms[form])
                   for form in ("halo", "all_gather")}
    w.p64_peer = {}
    for form in ("halo", "all_gather"):
        for dt in ("float64", "float32"):
            dp = w.p64_peer[(form, dt)] = DistPrec.from_host(
                w.mesh2, w.P64, chunk=64, dtype=np.dtype(dt), **forms[form])
            d[("p64 peer", form, dt)] = draw(
                rng, pair_shapes(dp.levels[0].L_op))
    w.p64_wide = {}
    for R in SWEEP_WIDE_RANKS:
        meshR = make_mesh(R, device="cuda")
        for form in ("halo", "all_gather"):
            dp = w.p64_wide[(R, form)] = DistPrec.from_host(
                meshR, w.P64, chunk=64, **forms[form])
            d[("p64 wide", R, form)] = draw(
                rng, pair_shapes(dp.levels[0].L_op))[0]
    d["xv"] = rng.standard_normal(w.A.nrows)
    w.mesh24 = make_mesh(DIST_RANKS, rhs=2, device="cuda")
    w.Ae = shard_ell_rows(w.mesh24, w.A)
    d["B4"] = rng.standard_normal((w.Ae.nrows, 4))
    w.Ac = convdiff2d(128)
    w.base = dict(FIXTURE_OPTS, use_native=0)
    w.Ph = ht.HIF().factorize(w.Ac, ht.Options(**w.base), device="cuda")
    d["bc"] = rng.standard_normal(w.Ac.nrows)

    # the kernel rows: K10a on a group of the two-group chunk form, the
    # sweep on level 0's L and on poisson2d(64)'s first halo-carried level,
    # the peer sweep on level 0's L of the two-group peer form
    w.hl = next(i for i, lv in enumerate(w.p64["halo"].levels)
                if isinstance(lv.L_op, HaloOp))
    w.p64_halo32 = DistPrec.from_host(w.mesh, w.P64, dtype=np.float32,
                                      chunk=64)
    for dt in ("float64", "float32"):
        op = next(lv.L_op for lv in w.dps2[dt].levels
                  if isinstance(lv.L_op, AGTrsvOp) and lv.L_op.nchunks)
        c = int(np.argmax([int((op.vals[0][i] != 0).sum())
                           for i in range(op.nchunks)]))
        R = op.cols[0][c].shape[0]
        d[("k10a row", dt)] = (c, rng.standard_normal((R, op.nslots + 1)))
        for row, dp, lvl in (
                ("sweep row", w.dps[dt], 0),
                ("peer row", w.dps_peer[(dt, "halo")], 0),
                ("halo row", w.p64["halo"] if dt == "float64"
                 else w.p64_halo32, w.hl)):
            op = dp.levels[lvl].L_op
            values = draw(rng, pair_shapes(op))
            # the right-hand side of the factor's library solve, which fed
            # a timing row: drawn, not read
            rng.standard_normal((op.n, 1))
            d[(row, dt)] = values
    return w


def dist_schur_run(w):
    """The ring Schur under ``dist_schur=1``: convdiff2d(128) on the
    anchors, every ``schur_spgemm_ring`` call recorded, counted.  Returns
    the factorization, the ring calls' (C, L_E, d, U_F) and the counts."""
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.parallel import schur

    calls = []
    ring = schur.schur_spgemm_ring

    def recording(C, L_E, d, U_F, mesh=None, device="cuda"):
        calls.append((C, L_E, d, U_F))
        return ring(C, L_E, d, U_F, mesh=mesh, device=device)

    schur.schur_spgemm_ring = recording
    try:
        Pd, counts = dist_count(lambda: ht.HIF().factorize(
            w.Ac, ht.Options(dist_schur=1, **w.base), device="cuda"))
    finally:
        schur.schur_spgemm_ring = ring
    return Pd, calls, counts
