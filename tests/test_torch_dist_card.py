"""The distribution (``hifir_tpu_torch/parallel``) on the card: DistPrec,
the halo and exchange paths, the sharded operators, the ring Schur, the
partitioned preconditioner, their kernels (K10a a chunk, the chunk sweep,
the peer sweep, K10b), the entry points, the DistPrec path matrix and, with
two cards or more, the legs over several cards.

Every part counts its launches from 0 with every card waited for (a wait
past 120 s ends the process) and no plain version called on the card:

- one group (eight ranks on the card) runs one chunk-sweep launch a factor
  application and no K10a; two groups of the card (``"cuda:0"`` and
  ``"cuda"``) run the peer sweep, one launch a factor application, or in
  the chunk form K10a a chunk a group; one group a card over several cards
  one peer-sweep launch a card (K10a a chunk where a pair of cards lacks
  peer access);
- poisson2d(512) in f64 and f32 within 1e-12 / 1e-4 of the host solve;
  poisson2d(64)'s forms within 1e-12, its peer and wide-cluster sweeps
  against the plain versions;
- the kernels alone against their plain versions (1e-12 / 1e-5), K10b
  also on seeded shapes of its wider tiers and on edge cases through every
  tier that holds them (columns exactly, two launches bitwise equal).

Seeds: ``default_rng(6)`` (``card_common.dist_world``), K10b's own shapes
``default_rng(7)``, the path matrix ``default_rng(8)``, the multi-card
legs ``default_rng(10)``.  Every test needs an NVIDIA GPU and skips without
one, the multi-card legs without a second card; on the card:
``python3 -m pytest tests/test_torch_dist_card.py -q --noconftest``.
"""

import types

import numpy as np
import pytest
import torch

import hifir_tpu_torch as ht
from hifir_tpu_torch.options import PIVOTING_ON
from card_common import (DIST_CHUNK, DIST_RANKS, K10B_EDGES, K10B_SHAPES,
                         RED_OPTS, SEED, SWEEP_WIDE_RANKS, case_id, counted,
                         dist_count, dist_graph_cell, dist_schur_run,
                         dist_solve_factors, dist_world, draw, k10a_gates,
                         k10b_inputs, k10b_run, pair_shapes, peer_gates,
                         peer_pair, rel_diff, skip_without_card, sweep_gates,
                         sweep_pair, want_launches)

pytestmark = pytest.mark.card


@pytest.fixture(scope="module", autouse=True)
def card():
    skip_without_card()


DTYPES = ("float64", "float32")
SOLVE_TOL = {"float64": 1e-12, "float32": 1e-4}
KERNEL_TOL = {"float64": 1e-12, "float32": 1e-5}
FORMS = ("halo", "all_gather")


@pytest.fixture(scope="module")
def world():
    return dist_world()


def solve_err(dp, b, xh):
    """One counted DistPrec solve: its relative error against the host's
    ``xh``, the counts and what carries the factors."""
    x, per = dist_count(lambda: dp.solve(b))
    x = x.double().cpu().numpy()
    return float(np.abs(x - xh).max() / np.abs(xh).max()), per, \
        dist_solve_factors(dp)


# ---------------------------------------------------------------------------
# poisson2d(512)

@pytest.mark.parametrize("dt", DTYPES)
def test_p512_one_group(dt, world):
    """The one-group sweep; against the host and the single-device solve."""
    dp = world.dps[dt]
    x, per = dist_count(lambda: dp.solve(world.b))
    x = x.double().cpu().numpy()
    xmax = np.abs(world.xh).max()
    xs = world.single.solve(world.b).cpu().numpy()
    assert float(np.abs(x - world.xh).max() / xmax) <= SOLVE_TOL[dt]
    assert float(np.abs(x - xs).max() / xmax) <= SOLVE_TOL[dt]
    sweep_gates(per, dist_solve_factors(dp), f"DistPrec {dt}")
    assert per["K1"] > 0 and per["sweep"] > 0


@pytest.mark.parametrize("dt", DTYPES)
def test_p512_two_groups_chunk_form(dt, world):
    """K10a a chunk a group, the legs as copies (``form="chunk"``)."""
    assert len(world.mesh2.groups()) == 2
    err, per, shape = solve_err(world.dps2[dt], world.b, world.xh)
    assert err <= SOLVE_TOL[dt]
    k10a_gates(per, shape, 2, f"DistPrec {dt} two groups")
    assert per["K10a"] > 0


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dt", DTYPES)
def test_p512_two_groups_peer_form(dt, form, world):
    """The layout's own form on two groups of one card: one peer-sweep
    launch a factor application, the groups two clusters of it."""
    err, per, shape = solve_err(world.dps_peer[(dt, form)], world.b,
                                world.xh)
    assert err <= SOLVE_TOL[dt]
    peer_gates(per, shape, 1, f"DistPrec {dt} peer {form}")
    assert per["peer"] > 0


# ---------------------------------------------------------------------------
# poisson2d(64): the halo and exchange paths at full depth

def test_p64_levels(world):
    assert world.P64.levels() >= 3


@pytest.mark.parametrize("form", ["halo", "all_gather", "whole vectors"])
def test_p64_one_group(form, world):
    dp = world.p64[form]
    err, per, shape = solve_err(dp, world.b64, world.xh64)
    assert err <= 1e-12
    sweep_gates(per, shape, f"poisson2d(64) {form}")
    if form == "halo":
        assert dp.comm_elems < 0.5 * dp.allgather_elems
        assert dp.n_halo >= 4
        assert all(lvl.xin is not None and lvl.xin.comm_elems
                   < lvl.xin.allgather_elems for lvl in dp.levels[1:]), \
            "an exchange plan is missing or not cheaper"
    if form == "whole vectors":
        assert all(lvl.xin is None for lvl in dp.levels)


@pytest.mark.parametrize("form", FORMS)
def test_p64_two_groups_chunk_form(form, world):
    err, per, shape = solve_err(world.p64_chunk[form], world.b64,
                                world.xh64)
    assert err <= 1e-12
    k10a_gates(per, shape, 2, f"poisson2d(64) {form} two groups")


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("form", FORMS)
def test_p64_two_groups_peer_form(form, dt, world):
    """The peer form, and its level-0 L against the plain peer sweep."""
    dp = world.p64_peer[(form, dt)]
    err, per, shape = solve_err(dp, world.b64, world.xh64)
    assert err <= SOLVE_TOL[dt]
    peer_gates(per, shape, 1, f"poisson2d(64) {form} {dt} peer")
    _, _, Y, Yp = peer_pair(None, dp.levels[0].L_op, dp.dtype,
                            world.draws[("p64 peer", form, dt)])
    assert rel_diff(Y, Yp) <= KERNEL_TOL[dt]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("R", SWEEP_WIDE_RANKS)
def test_p64_wide_clusters(R, form, world):
    """16 ranks (a non-portable cluster of 16 CTAs), 17 and 32 (two ranks a
    CTA, the last CTA of 17 with one); level 0's L against the plain
    sweep."""
    dp = world.p64_wide[(R, form)]
    err, per, shape = solve_err(dp, world.b64, world.xh64)
    assert err <= 1e-12
    sweep_gates(per, shape, f"poisson2d(64) {form} {R} ranks")
    _, _, xk, xp = sweep_pair(None, dp.levels[0].L_op, dp.dtype,
                              world.draws[("p64 wide", R, form)])
    assert rel_diff(xk, xp) <= 1e-12


# ---------------------------------------------------------------------------
# sharded operators, the IR step, the ring Schur, PartitionedHIF

def test_sharded_and_halo_spmv(world):
    """The sharded SpMV on the (2, 4) mesh and the halo SpMV on eight ranks
    against K1 on poisson2d(512)'s A."""
    from hifir_tpu_torch.ops.spmv import (sliced_ell_from_csr,
                                          sliced_ell_sub_mrhs)
    from hifir_tpu_torch.parallel import (build_halo_spmv, halo_spmv,
                                          sharded_spmv)

    n = world.A.nrows
    Aw = sliced_ell_from_csr(world.A, dtype=np.float64, device="cuda")
    xv = torch.as_tensor(world.draws["xv"], dtype=torch.float64,
                         device="cuda")
    yk = sliced_ell_sub_mrhs(Aw, xv[:, None])[:, 0]
    ys, _ = dist_count(lambda: sharded_spmv(world.mesh24, world.Ae, xv))
    H = build_halo_spmv(world.mesh, world.A)
    xpad = torch.zeros(H.nb * DIST_RANKS, dtype=torch.float64, device="cuda")
    xpad[:n] = xv
    yh, _ = dist_count(lambda: halo_spmv(H, xpad))
    assert rel_diff(ys[:n], yk) <= 1e-12 and rel_diff(yh[:n], yk) <= 1e-12


def ir_residuals(step, Ae, single, Aw, B, n):
    """Five sharded IR steps from X = 0: the largest relative residual of
    the start and after each step."""
    from hifir_tpu_torch.ops.spmv import sliced_ell_sub_mrhs

    X = torch.zeros_like(B)
    res = [1.0]
    for _ in range(5):
        X = step(Ae, single.levels, single.tail, X, B)
        R = sliced_ell_sub_mrhs(Aw, X[:n], B[:n])
        res.append(float((R.norm(dim=0) / B[:n].norm(dim=0)).max()))
    return res


def test_ir_step_2x4(world):
    from hifir_tpu_torch.ops.spmv import sliced_ell_from_csr
    from hifir_tpu_torch.parallel import make_sharded_ir_step

    n = world.A.nrows
    Aw = sliced_ell_from_csr(world.A, dtype=np.float64, device="cuda")
    step = make_sharded_ir_step(world.mesh24, n)
    B = torch.as_tensor(world.draws["B4"], dtype=torch.float64,
                        device="cuda")
    B[n:] = 0
    res, _ = dist_count(lambda: ir_residuals(step, world.Ae, world.single,
                                             Aw, B, n))
    assert all(b < a for a, b in zip(res, res[1:])), res


@pytest.fixture(scope="module")
def dist_schur(world):
    return dist_schur_run(world)


def test_dist_schur(world, dist_schur):
    """dist_schur=1 on convdiff2d(128): levels and tail equal to the host
    Schur's, the solves within 1e-12, one K10b launch a ring step (eight
    ranks on one card are one group: eight steps a level whose tail has
    rows)."""
    Pd, calls, counts = dist_schur
    Ph = world.Ph
    assert [(p.m, p.n) for p in Pd.precs] == [(p.m, p.n) for p in Ph.precs]
    terr = 0.0
    if Ph.precs[-1].dense_matrix is not None:
        dh, dd = Ph.precs[-1].dense_matrix, Pd.precs[-1].dense_matrix
        terr = float(np.abs(dd - dh).max() / np.abs(dh).max())
    bc = world.draws["bc"]
    xch = Ph.solve(bc)
    serr = float(np.abs(Pd.solve(bc) - xch).max() / np.abs(xch).max())
    assert terr <= 1e-12 and serr <= 1e-12
    steps = 8 * sum(1 for c in calls if c[1].nrows)
    assert counts["K10b"] == steps > 0


def test_partitioned(world):
    """PartitionedHIF, eight parts of poisson2d(512): to_device and a
    DistPrec a part (one sweep launch a factor application) within 1e-12
    of the host RAS; the adjoint stays on the host path."""
    from hifir_tpu_torch.parallel import PartitionedHIF

    b = world.b
    PP = PartitionedHIF().factorize(world.A, 8, ht.Options(verbose=0))
    xr = PP.solve(b)
    rmax = np.abs(xr).max()
    dpp = PP.to_device(device="cuda")
    xd, _ = dist_count(lambda: dpp.solve(b))
    PP.attach_dist_solvers(world.mesh, chunk=DIST_CHUNK, max_halo_chunks=128)
    xa, per = dist_count(lambda: PP.local_contrib(b))
    assert np.array_equal(PP.local_contrib(b, trans=True),
                          PP.solve(b, trans=True)), \
        "the partitioned adjoint left the host path"
    assert float(np.abs(xd - xr).max() / rmax) <= 1e-12
    assert float(np.abs(xa - xr).max() / rmax) <= 1e-12
    parts = [dist_solve_factors(p.M_dist) for p in PP.parts
             if p.M_dist is not None]
    shape = dict(factors=sum(f["factors"] for f in parts),
                 forms=sorted({x for f in parts for x in f["forms"]}))
    assert shape["factors"] > 0
    sweep_gates(per, shape, "partitioned DistPrec")


# ---------------------------------------------------------------------------
# the kernels alone

@pytest.mark.parametrize("dt", DTYPES)
def test_k10a_chunk_equals_plain(dt, world):
    """K10a on group 0's ranks at the chunk of the first all_gather L factor
    (with chunks) that holds the most dependency entries."""
    from hifir_tpu_torch.ops import chunk
    from hifir_tpu_torch.parallel.prec_sharded import AGTrsvOp

    dp = world.dps2[dt]
    op = next(lv.L_op for lv in dp.levels
              if isinstance(lv.L_op, AGTrsvOp) and lv.L_op.nchunks)
    assert op.plan.form == "chunk"
    g = dp.mesh.groups()[0]
    c, values = world.draws[("k10a row", dt)]
    cols, vals = op.cols[0][c], op.vals[0][c]
    R, cloc, _ = cols.shape
    out_off, out_step = c * op.chunk + g.lo * cloc, cloc
    x0 = torch.as_tensor(values, dtype=dp.dtype, device=cols.device)
    x0[:, -1] = 0
    xk, xp = x0.clone(), x0.clone()
    chunk.ChunkSweep(xk)(cols, vals, out_off, out_step)
    chunk.chunk_fma_plain(xp, cols, vals, out_off, out_step)
    pos = (out_off + out_step * torch.arange(R, device=x0.device)[:, None]
           + torch.arange(cloc, device=x0.device))
    assert rel_diff(xk.gather(1, pos), xp.gather(1, pos)) <= KERNEL_TOL[dt]


@pytest.mark.parametrize("row", ["sweep row", "halo row"])
@pytest.mark.parametrize("dt", DTYPES)
def test_sweep_equals_plain(dt, row, world):
    """The chunk sweep: one application of level 0's L of poisson2d(512)
    (all_gather form), and of poisson2d(64)'s first halo-carried level,
    on every rank, against ``chunk_sweep_plain``."""
    if row == "sweep row":
        op = world.dps[dt].levels[0].L_op
    else:
        dp = world.p64["halo"] if dt == "float64" else world.p64_halo32
        op = dp.levels[world.hl].L_op
    _, _, xk, xp = sweep_pair(None, op, getattr(torch, dt),
                              world.draws[(row, dt)][0])
    assert rel_diff(xk, xp) <= KERNEL_TOL[dt]


@pytest.mark.parametrize("dt", DTYPES)
def test_peer_sweep_equals_plain(dt, world):
    op = world.dps_peer[(dt, "halo")].levels[0].L_op
    _, _, Y, Yp = peer_pair(None, op, getattr(torch, dt),
                            world.draws[("peer row", dt)])
    assert rel_diff(Y, Yp) <= KERNEL_TOL[dt]


@pytest.mark.parametrize("dt", DTYPES)
def test_k10b_ring_step_equals_plain(dt, world, dist_schur):
    """K10b at the largest level's ring-step shape of the dist_schur
    factorize, every rank at once."""
    from hifir_tpu_torch.parallel import schur

    _, calls, _ = dist_schur
    C, L_E, d, U_F = max(calls, key=lambda c: c[1].nrows)
    D = world.mesh.D
    nm, m = L_E.nrows, L_E.ncols
    nmp = -(-nm // D) * D
    nb = cb = nmp // D
    le_i, le_v, KL = schur._ell_pack(L_E, nmp, sentinel=m)
    uf_i, uf_v, _ = schur._panelize_uf(U_F, D, cb)
    d_ext = np.concatenate([np.asarray(d), [0.0]])
    ops = (le_i.reshape(D, nb, KL), le_v.reshape(D, nb, KL),
           np.broadcast_to(d_ext, (D, m + 1)), uf_i, uf_v)
    k10b_run(ops, cb, getattr(torch, dt), f"convdiff2d(128) nm={nm}")


@pytest.fixture(scope="module")
def k10b_ops():
    """K10b's seeded shapes, then its edge cases, from ``default_rng(7)``
    (the same operands in both dtypes)."""
    rng = np.random.default_rng(SEED["k10b"])
    return {case[0]: k10b_inputs(rng, *case[1:])
            for case in K10B_SHAPES + K10B_EDGES}


@pytest.mark.parametrize("name", [c[0] for c in K10B_SHAPES])
@pytest.mark.parametrize("dt", DTYPES)
def test_k10b_seeded_tiers(dt, name, k10b_ops):
    cb = dict((c[0], c[4]) for c in K10B_SHAPES)[name]
    k10b_run(k10b_ops[name], cb, getattr(torch, dt), f"seeded {name}")


@pytest.mark.parametrize("name", [c[0] for c in K10B_EDGES], ids=case_id)
@pytest.mark.parametrize("dt", DTYPES)
def test_k10b_edges_every_tier(dt, name, k10b_ops):
    from hifir_tpu_torch.parallel.schur import _P_RANGE, SCHUR_TIERS

    _, _, _, _, cb, KL, KU, _ = next(c for c in K10B_EDGES if c[0] == name)
    tiers = [t for t in SCHUR_TIERS
             if KL * KU <= (_P_RANGE[t][1] or KL * KU)]
    assert tiers
    for tier in tiers:
        k10b_run(k10b_ops[name], cb, getattr(torch, dt), name, tier)


# ---------------------------------------------------------------------------
# the entry points

def test_entry():
    """``entry()``'s ``fn(*args)``: the f32 M-solve of convdiff2d(12) on 8
    columns of ones within 1e-4 of the host f64 solve, K1 and K2 launched
    as the pack's forms say."""
    from hifir_tpu_torch.entry import _small_prec, entry

    fn, args = entry()
    X, per, _ = counted(lambda: fn(*args))
    assert bool(torch.isfinite(X).all())
    _, M = _small_prec(nx=12)
    n = M.precs[0].n
    assert tuple(X.shape) == (n, 8) and X.dtype == torch.float32
    ref = M.solve_mrhs(np.ones((n, 8)))
    assert float(np.abs(X.double().cpu().numpy() - ref).max()
                 / np.abs(ref).max()) <= 1e-4
    want = want_launches([(v.L, v.U, v.E, v.F) for v in args[0]])
    assert {k: per[k] for k in want} == want
    assert per["K1"] > 0


def test_dryrun_multichip():
    """``dryrun_multichip(8)`` with its asserts, then its DistPrec's solve:
    one sweep launch a factor application, within 1e-8 of the host."""
    from hifir_tpu_torch.entry import dryrun_multichip

    rep, per = dist_count(lambda: dryrun_multichip(8))
    dp = rep["dist"]
    ones = np.ones(dp.levels[0].n)
    solve, sper = dist_count(lambda: dp.solve(ones))
    sweep_gates(sper, dist_solve_factors(dp), "dryrun_multichip(8) DistPrec")
    assert per["sweep"] == sper["sweep"] and per["K1"] > 0, per
    err = float(np.abs(solve.cpu().numpy() - rep["x_host"]).max()
                / np.abs(rep["x_host"]).max())
    assert err <= 1e-8


# ---------------------------------------------------------------------------
# the DistPrec path matrix

# path -> (operator, the options beyond RED_OPTS): the factorizations
# tests/test_torch_parallel_paths.py holds to the JAX DistPrec
PATHS = {"symmetric": ("poisson2d", dict(is_symm=1)),
         "nonsymmetric": ("convdiff2d", {}),
         "pivoting": ("convdiff2d", dict(pivot=PIVOTING_ON))}


@pytest.fixture(scope="module")
def paths():
    """Each path's factorization (built at first use) and right-hand side,
    drawn from ``default_rng(8)`` a path in turn."""
    from hifir_tpu_torch.models import problems
    from hifir_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(SEED["paths"])
    mats = {p: getattr(problems, op)(64) for p, (op, _) in PATHS.items()}
    bs = {p: rng.standard_normal(A.nrows) for p, A in mats.items()}
    built = {}

    def of(path):
        if path not in built:
            P = ht.HIF().factorize(mats[path], ht.Options(
                **dict(RED_OPTS, **PATHS[path][1])))
            built[path] = (P, bs[path], P.solve(bs[path]))
        return built[path]

    return types.SimpleNamespace(of=of, mesh=make_mesh(DIST_RANKS))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("path", list(PATHS))
def test_path_matrix(path, form, dt, paths):
    from hifir_tpu_torch.parallel import DistPrec

    P, b, xh = paths.of(path)
    dp = DistPrec.from_host(paths.mesh, P, dtype=np.dtype(dt), chunk=64,
                            halo=form == "halo")
    err, per, shape = solve_err(dp, b, xh)
    assert err <= SOLVE_TOL[dt]
    sweep_gates(per, shape, f"DistPrec {path} {form} {dt}")
    assert per["sweep"] > 0 and per["K1"] > 0
    if form == "halo":
        assert dp.n_halo > 0 and dp.comm_elems < dp.allgather_elems


# ---------------------------------------------------------------------------
# several cards: one group of ranks a card

@pytest.fixture(scope="module")
def cards(world):
    """The legs over 4 cards (2 with two or three): the mesh with one group
    a card, poisson2d(512)'s DistPrecs on it (f64 and f32, halo and
    all_gather, and the f64 halo chunk form), the (2, 4) mesh over the
    cards, and every input drawn from ``default_rng(10)``."""
    from hifir_tpu_torch.parallel import DistPrec, make_mesh, shard_ell_rows

    skip_without_card(2)
    count = torch.cuda.device_count()
    k = 4 if count >= 4 else 2
    c = types.SimpleNamespace(k=k, cards=[f"cuda:{i}" for i in range(k)])
    c.devices = [d for d in c.cards for _ in range(DIST_RANKS // k)]
    c.reach = all(i == j or torch.cuda.can_device_access_peer(i, j)
                  for i in range(k) for j in range(k))
    c.mesh = make_mesh(devices=c.devices)
    kw = dict(chunk=DIST_CHUNK, max_halo_chunks=128)
    c.dps = {(dt, form): DistPrec.from_host(c.mesh, world.P,
                                            dtype=np.dtype(dt),
                                            halo=form == "halo", **kw)
             for dt in DTYPES for form in FORMS}
    c.dpc = DistPrec.from_host(c.mesh, world.P, form="chunk", graphs=False,
                               **kw)
    c.mesh24 = make_mesh(DIST_RANKS, rhs=2, devices=c.devices)
    c.Ae = shard_ell_rows(c.mesh24, world.A)
    rng = np.random.default_rng(SEED["multicard"])
    if c.reach:
        c.pair = draw(rng, pair_shapes(c.dps[("float64", "halo")]
                                       .levels[0].L_op))
        c.rows = {}
        for dt in DTYPES:
            op = c.dps[(dt, "halo")].levels[0].L_op
            c.rows[dt] = draw(rng, pair_shapes(op))
            # the right-hand side of the factor's library solve, which fed
            # a timing row: drawn, not read
            rng.standard_normal((op.n, 1))
    c.B4 = rng.standard_normal((c.Ae.nrows, 4))
    c.bc = rng.standard_normal(world.Ac.nrows)
    return c


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dt", DTYPES)
def test_cards_distprec(dt, form, world, cards):
    """One peer-sweep launch a card a factor application (K10a a chunk where
    a pair of cards lacks peer access), within 1e-12 / 1e-4 of the host."""
    assert len(cards.mesh.groups()) == cards.k
    err, per, shape = solve_err(cards.dps[(dt, form)], world.b, world.xh)
    assert err <= SOLVE_TOL[dt]
    what = f"{cards.k} cards DistPrec {dt} {form}"
    if cards.reach:
        peer_gates(per, shape, cards.k, what)
    else:
        k10a_gates(per, shape, cards.k, what)


def test_cards_chunk_form(world, cards):
    """The f64 halo solve in the chunk form: K10a a chunk, the legs as
    copies between cards."""
    err, per, shape = solve_err(cards.dpc, world.b, world.xh)
    assert err <= 1e-12
    k10a_gates(per, shape, cards.k, f"{cards.k} cards chunk form")


@pytest.mark.parametrize("form", ["peer", "chunk"])
def test_cards_graph_replay(form, world, cards):
    """One graph over the cards: the replay against the eager solve bit for
    bit and the host solve within 1e-12."""
    dp = cards.dps[("float64", "halo")] if form == "peer" else cards.dpc
    dist_graph_cell(dp, lambda: dp.solve(world.b),
                    ref=torch.as_tensor(world.xh), tol=1e-12)


@pytest.mark.parametrize("what", ["pair", "float64", "float32"])
def test_cards_peer_sweep_equals_plain(what, cards):
    """Level 0's L over the cards against the plain peer sweep."""
    if not cards.reach:
        pytest.skip("a pair of the cards lacks peer access: no peer sweep")
    dt = "float64" if what == "pair" else what
    values = cards.pair if what == "pair" else cards.rows[dt]
    op = cards.dps[(dt, "halo")].levels[0].L_op
    _, _, Y, Yp = peer_pair(None, op, getattr(torch, dt), values)
    assert rel_diff(Y, Yp) <= KERNEL_TOL[dt]


def test_cards_dryrun(cards):
    """``dryrun_multichip`` with one rank a card, its asserts, then its
    DistPrec's solve within 1e-8 of the host."""
    from hifir_tpu_torch.entry import dryrun_multichip

    r, _ = dist_count(lambda: dryrun_multichip(cards.k,
                                               devices=cards.cards))
    dp = r["dist"]
    ones = np.ones(dp.levels[0].n)
    x, per = dist_count(lambda: dp.solve(ones))
    err = float(np.abs(x.cpu().numpy() - r["x_host"]).max()
                / np.abs(r["x_host"]).max())
    assert err <= 1e-8
    if cards.reach:
        peer_gates(per, dist_solve_factors(dp), cards.k, "dryrun")


def test_cards_ir_step(world, cards):
    """Five IR steps on a (2, 4) mesh over the cards: the residual falls
    every step."""
    from hifir_tpu_torch.ops.spmv import sliced_ell_from_csr
    from hifir_tpu_torch.parallel import make_sharded_ir_step

    n = world.A.nrows
    Aw = sliced_ell_from_csr(world.A, dtype=np.float64, device="cuda:0")
    step = make_sharded_ir_step(cards.mesh24, n)
    B = torch.as_tensor(cards.B4, dtype=torch.float64, device="cuda")
    B[n:] = 0
    res, per = dist_count(lambda: ir_residuals(step, cards.Ae, world.single,
                                               Aw, B, n))
    assert all(b < a for a, b in zip(res, res[1:])), res
    assert per["K1"] > 0


def test_cards_dist_schur(world, cards):
    """dist_schur=1 with the ring over the cards: levels and tail equal to
    the host Schur's, one K10b launch a group a ring step."""
    from hifir_tpu_torch.parallel import make_mesh, schur

    calls = []
    ring = schur.schur_spgemm_ring

    def over_cards(C, L_E, d, U_F, mesh=None, device="cuda"):
        calls.append(L_E.nrows)
        return ring(C, L_E, d, U_F, mesh=make_mesh(devices=cards.devices))

    schur.schur_spgemm_ring = over_cards
    try:
        Pd, per = dist_count(lambda: ht.HIF().factorize(
            world.Ac, ht.Options(dist_schur=1, **world.base),
            device="cuda:0"))
    finally:
        schur.schur_spgemm_ring = ring
    Ph = world.Ph
    assert [(p.m, p.n) for p in Pd.precs] == [(p.m, p.n) for p in Ph.precs]
    terr = 0.0
    if Ph.precs[-1].dense_matrix is not None:
        dh, dd = Ph.precs[-1].dense_matrix, Pd.precs[-1].dense_matrix
        terr = float(np.abs(dd - dh).max() / np.abs(dh).max())
    xch = Ph.solve(cards.bc)
    serr = float(np.abs(Pd.solve(cards.bc) - xch).max() / np.abs(xch).max())
    assert terr <= 1e-12 and serr <= 1e-12
    steps = cards.k * DIST_RANKS * sum(1 for rows in calls if rows)
    assert per["K10b"] == steps > 0
