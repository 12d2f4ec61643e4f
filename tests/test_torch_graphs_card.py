"""The graph layer (``hifir_tpu_torch/graphs.py``) on the card: captured
CUDA graphs against eager dispatch, on one device and over the
distribution's meshes, and the device demos.

- K1, K2 and K7 each captured alone and replayed, held to the plain
  version (1e-5 / 1e-12), one launch a replay.
- Each call cell run eagerly (graphs off) and replayed: the replay held to
  the eager run (bit for bit up to ``GRAPH_TOL``), no synchronisation
  inside a replay (``torch.cuda.set_sync_debug_mode("error")``), five
  replays counting five times one eager call's launches.  The frozen
  fixture's forward, adjoint and rank-override M-solves on its four packs,
  HIFIR nirs = 4 with the BSR A, the nonsymmetric fixture's products (one
  vector and 128 columns, both ways), the 1M f32 solve at 64 and 1 RHS.
- The GMRES drivers on the nonsymmetric fixture both ways: flags 0, counts
  within one, x within 1e-10, equal launches where the counts are equal,
  host reads at most ceil(iterations / SEGMENT) + cycles (once a cycle for
  gmres_mrhs), no replay synchronising.
- The distribution's jit sites: every DistPrec layout of poisson2d(512)
  and poisson2d(64), eager and replayed peer-form solves interleaved, the
  sharded IR step, the halo SpMV, the ring's step and the dist_schur
  factorize with its rings replayed, dryrun_multichip(8)'s DistPrec: the
  replay bit-equal to the eager run, within 1e-12 / 1e-4 (1e-8 for the
  dry run) of the host, launches counted as above.
- demo_device_batch and demo_pseudoinverse_device in-process.

Seeds: the kernels' inputs from ``default_rng(11)``, the frozen cells'
block is the main path's (``default_rng(0)`` after the kernel rows), the
nonsymmetric cells' the surface's (``default_rng(1)``), the 1M cells' the
1M block (``default_rng(4)``), the halo SpMV's input
``default_rng(12)``, the distribution's operators ``default_rng(6)``.
Every test needs an NVIDIA GPU and skips without one; on the card:
``python3 -m pytest tests/test_torch_graphs_card.py -q --noconftest``.
"""

import types

import numpy as np
import pytest
import torch

import hifir_tpu_torch as ht
from card_common import (CONVDIFF, DIST_CHUNK, DIST_RANKS, FIXTURE,
                         GRAPH_REPS, NRHS, SEED, counted, dist_count,
                         dist_graph_cell, dist_schur_run, dist_world, draw,
                         host_syncs, main_rhs, read_counts, rel_diff,
                         replays_without_sync, reset_counts, same,
                         skip_without_card, sync_all)
from hifir_tpu_torch import graphs
from hifir_tpu_torch.models.problems import convdiff2d, poisson2d
from hifir_tpu_torch.ops.bsr_spmv import bsr_from_csr
from hifir_tpu_torch.ops.spmv import sliced_ell_from_csr

pytestmark = pytest.mark.card


@pytest.fixture(scope="module", autouse=True)
def card():
    skip_without_card()


# a replay against the same pack run eagerly: both run the same kernels on
# the same inputs, so they should agree bit for bit; cuBLAS may still pick
# another algorithm (split-K or not) under capture, whose sums round
# differently
GRAPH_TOL = {"float32": 1e-6, "float64": 1e-12}
KERNELS = ("K7", "K1", "K2")
PACKS = [(di, dt) for di in ("auto", 0) for dt in ("float32", "float64")]


def kernel_counts() -> dict:
    return {k: v for k, v in read_counts().items() if k in KERNELS}


@pytest.fixture(scope="module")
def frozen():
    """The main path's packs of the frozen fixture (their adjoints packed)
    and block, HIFIR's BSR A."""
    M, Mc = ht.load_prec(FIXTURE), ht.load_prec(CONVDIFF)
    B = main_rhs(M, Mc)
    packs = {}
    for di, dt in PACKS:
        dp = packs[(di, dt)] = M.to_device(dtype=np.dtype(dt), dense_inv=di)
        dp.pack_transpose(M.precs)
    return types.SimpleNamespace(
        M=M, packs=packs, Ab=bsr_from_csr(poisson2d(128), bs=128,
                                          dtype=np.float64),
        Bd={dt: torch.as_tensor(B, dtype=getattr(torch, dt), device="cuda")
            for dt in ("float32", "float64")})


@pytest.fixture(scope="module")
def kernel_inputs(frozen):
    """The kernels' inputs from ``default_rng(11)``: per dtype, K1 (X then C
    of level 0's E), K2 (B of level 0's L), K7 (X), each drawn twice (the
    capture's, then the replay's)."""
    rng = np.random.default_rng(SEED["graphs"])
    h0 = frozen.M.precs[0]
    shapes = {"K1": [(h0.m, NRHS), (h0.n - h0.m, NRHS)],
              "K2": [(h0.m, NRHS)], "K7": [(-(-h0.n // 128) * 128, NRHS)]}
    return {(dt, k): (draw(rng, s), draw(rng, s))
            for dt in ("float32", "float64") for k, s in shapes.items()}


@pytest.mark.parametrize("k", ["K1", "K2", "K7"])
@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_kernel_in_graph_equals_plain(dt, k, frozen, kernel_inputs):
    """Each kernel captured alone in a graph of its own cache and replayed:
    one launch, held to its plain version (1e-5 / 1e-12 of max|Y|)."""
    from hifir_tpu_torch.ops.bsr_spmv import (bsr_matvec_mrhs,
                                              bsr_matvec_mrhs_plain)
    from hifir_tpu_torch.ops.spmv import (sliced_ell_sub_mrhs,
                                          sliced_ell_sub_mrhs_plain)
    from hifir_tpu_torch.ops.trsv import trsv_apply_mrhs, trsv_apply_plain

    tdt = getattr(torch, dt)
    lv0 = frozen.packs[("auto", dt)].levels[0]
    dev = lv0.d.device
    Abt = frozen.Ab if dt == "float64" else bsr_from_csr(
        poisson2d(128), bs=128, dtype=np.float32, device=dev)
    fn, plain, op = {
        "K1": (sliced_ell_sub_mrhs, sliced_ell_sub_mrhs_plain, lv0.E),
        "K2": (trsv_apply_mrhs, trsv_apply_plain,
               frozen.packs[(0, dt)].levels[0].L),
        "K7": (bsr_matvec_mrhs, bsr_matvec_mrhs_plain, Abt)}[k]
    first, second = ([torch.as_tensor(a, dtype=tdt, device=dev) for a in x]
                     for x in kernel_inputs[(dt, k)])
    cache = graphs.GraphCache(graphs.CudaGraphs(dev))
    cache.call(fn, op, *first)                  # the warm-up and capture
    reset_counts()
    with replays_without_sync() as seen:
        Y = cache.call(fn, op, *second)
    torch.cuda.synchronize()
    launched = read_counts()[k]
    assert len(seen) == 1 and launched == 1, (len(seen), launched)
    d = rel_diff(Y, plain(op, *second))
    assert d <= (1e-5 if dt == "float32" else 1e-12), f"{d:.3e}"


def graph_cell(dp, run, dt):
    """One call cell on pack ``dp``: ``run()`` eagerly and as a replay, the
    replay held to the eager run with no synchronisation inside it, five
    replays counting five times one eager call's launches.  Returns the
    replays' launches."""
    dp.graphs = False
    torch.cuda.synchronize()
    reset_counts()
    Xe = run()
    torch.cuda.synchronize()
    eager = kernel_counts()
    dp.graphs, dp.graph_cache = True, None
    run()
    torch.cuda.synchronize()
    assert len(dp.graph_cache.entries) == 1
    torch.cuda.set_sync_debug_mode("error")
    try:
        Xr = run()
        reset_counts()
        for _ in range(GRAPH_REPS):
            run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    got = kernel_counts()
    d = rel_diff(Xr.to(Xe.dtype), Xe)
    assert d <= GRAPH_TOL[dt], f"replay vs eager {d:.3e}"
    for k, c in eager.items():
        assert got[k] == GRAPH_REPS * c, (
            f"{got[k]} {k} launches in {GRAPH_REPS} replays, one eager "
            f"call {c}")
    return got


@pytest.mark.parametrize("call", ["forward", "adjoint", "rank"])
@pytest.mark.parametrize("pack", PACKS,
                         ids=lambda p: f"dense_inv={p[0]}-{p[1]}")
def test_frozen_solve_cells(pack, call, frozen):
    """The frozen fixture's forward, adjoint and rank-override (3/4 of the
    tail's rank) M-solves at 128 RHS."""
    di, dt = pack
    dp, B = frozen.packs[pack], frozen.Bd[dt]
    r = round(0.75 * frozen.M.precs[-1].dense_solver.rank)
    run = {"forward": lambda: dp.solve_mrhs(B),
           "adjoint": lambda: dp.solve_mrhs(B, trans=True),
           "rank": lambda: dp.solve_mrhs(B, r=r)}[call]
    got = graph_cell(dp, run, dt)
    if di == 0:
        assert got["K1"] > 0 and got["K2"] > 0


def test_frozen_hifir_cell(frozen):
    dp = frozen.packs[("auto", "float64")]
    got = graph_cell(dp, lambda: ht.ir_apply(frozen.Ab, dp,
                                             frozen.Bd["float64"], 4),
                     "float64")
    assert got["K7"] > 0


@pytest.fixture(scope="module")
def convdiff():
    """The surface's ``auto`` f64 pack of the nonsymmetric fixture (adjoint
    and products packed), its block and A as sliced ELL and BSR."""
    M = ht.load_prec(CONVDIFF)
    A = convdiff2d(128)
    sp = M.to_device(dtype=np.float64, dense_inv="auto", device="cuda")
    sp.pack_transpose(M.precs)
    sp.pack_prod(M.precs)
    sp.pack_prod_tran(M.precs)
    (B,) = draw(np.random.default_rng(SEED["surface"]), [(A.nrows, NRHS)])
    sB = torch.as_tensor(B, dtype=torch.float64, device=sp.device)
    return types.SimpleNamespace(
        M=M, sp=sp, sB=sB, sb=sB[:, 0].contiguous(),
        sell=sliced_ell_from_csr(A, device="cuda"),
        bsr=bsr_from_csr(A, bs=128, device="cuda"))


@pytest.mark.parametrize("call", ["vector", "vector adjoint", "columns",
                                  "columns adjoint"])
def test_convdiff_product_cells(call, convdiff):
    """M x and M^H x through ``mmultiply`` (one vector) and 128 columns
    through ``graphs.jit``."""
    from hifir_tpu_torch.alg.prec import prec_prod_mrhs, prec_prod_tran_mrhs

    sp, sB, sb = convdiff.sp, convdiff.sB, convdiff.sb
    prod = graphs.jit(sp, prec_prod_mrhs)
    prod_t = graphs.jit(sp, prec_prod_tran_mrhs)
    run = {"vector": lambda: sp.mmultiply(sb),
           "vector adjoint": lambda: sp.mmultiply(sb, trans=True),
           "columns": lambda: prod(sp.levels, sp.prod, sp.tail, sB),
           "columns adjoint": lambda: prod_t(sp.levels, sp.tran,
                                             sp.prod_tran, sp.tail, sB)}[call]
    graph_cell(sp, run, "float64")


@pytest.fixture(scope="module")
def million():
    """poisson2d(1024)'s ``auto`` f32 pack and the 1M block of 64 columns."""
    A = poisson2d(1024)
    P = ht.HIF().factorize(A, ht.Options(verbose=0))
    B = np.random.default_rng(SEED["million"]).standard_normal((A.nrows, 64))
    mp = P.to_device(dtype=np.float32)
    return mp, torch.as_tensor(B, dtype=torch.float32, device="cuda")


@pytest.mark.parametrize("nrhs", [64, 1])
def test_million_solve_cells(nrhs, million):
    mp, mB = million
    mb = mB[:, 0].contiguous()
    graph_cell(mp, (lambda: mp.solve_mrhs(mB)) if nrhs == 64
               else (lambda: mp.solve(mb)), "float32")


@pytest.mark.parametrize("name", ["gmres_hif", "fgmres_hifir", "gmres_mrhs"])
def test_gmres_cells(name, convdiff):
    """A GMRES driver eagerly and from captured graphs: flags 0, counts
    within one, x within 1e-10; the replayed run reads the host at most
    ceil(its / SEGMENT) + cycles times at restart 30 (a batched run once a
    cycle), no replay synchronises, equal launches where the counts are
    equal."""
    from hifir_tpu_torch.solvers.gmres import SEGMENT

    sp, sb, sB = convdiff.sp, convdiff.sb, convdiff.sB
    crank = convdiff.M.precs[-1].dense_solver.rank
    run, bound_of = {
        "gmres_hif": (lambda: ht.gmres_hif(convdiff.sell, sp, sb), None),
        "fgmres_hifir": (lambda: ht.fgmres_hifir(convdiff.sell, sp, sb,
                                                 rank=crank), None),
        "gmres_mrhs": (lambda: ht.gmres_mrhs(convdiff.bsr, sp, sB),
                       lambda cycles: cycles)}[name]
    bound_of = bound_of or (lambda its: -(-its // SEGMENT) + -(-its // 30))

    def synced(fn):
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        return out

    sp.graphs = False
    reset_counts()
    (xe, fe, ce), _ = synced(lambda: host_syncs(run))
    eager = kernel_counts()
    sp.graphs, sp.graph_cache = True, None
    synced(run)                     # the first cycle captures
    reset_counts()
    with replays_without_sync() as seen:
        (xr, fr, cr), reads = synced(lambda: host_syncs(run))
    got = kernel_counts()
    assert fe == 0 and fr == 0
    assert abs(ce - cr) <= 1, f"{cr} replayed against {ce} eager"
    assert rel_diff(xr, xe) <= 1e-10
    assert reads <= bound_of(cr), f"{reads} host reads > {bound_of(cr)}"
    assert len(seen) > 0, "no replay"
    if ce == cr:
        assert got == eager


# ---------------------------------------------------------------------------
# the device demos

def test_demo_device_batch():
    """poisson2d(128), a float32 64-RHS M-solve within 1e-4 of the host's
    on 8 columns, fgmres_hifir to rtol 1e-8: flag 0, residual within 1.01
    rtol."""
    from hifir_tpu_torch.examples import demo_device_batch

    r, per, _ = counted(lambda: demo_device_batch.main([]))
    cols = np.linspace(0, r["X"].shape[1] - 1, 8).astype(int)
    Bh = r["B"].double().cpu().numpy()
    ref = np.stack([r["M"].solve(Bh[:, c]) for c in cols], axis=1)
    X = r["X"][:, torch.as_tensor(cols, device=r["X"].device)]
    d = float(np.abs(X.double().cpu().numpy() - ref).max()
              / np.abs(ref).max())
    assert r["flag"] == 0 and r["res"] <= 1.01e-8
    assert d <= 1e-4
    assert per["K1"] > 0


def test_demo_pseudoinverse_device():
    """The 40x40 rank-deficient system: the null space found, the relative
    residual and the distance to pinv within the module's bounds, one
    float32 filtered apply within 1e-4 of the host's filtered solve."""
    from hifir_tpu_torch.examples import demo_pseudoinverse_device as demo

    r = demo.main([])
    M, dp = r["M"], r["dp"]
    M.nsp = dp.nsp
    xh = M.solve(r["b"])
    xd = dp.solve(torch.as_tensor(r["b"], dtype=torch.float64,
                                  device=dp.device)).double().cpu().numpy()
    assert r["rank"] < r["tail_n"], "the null space was not found"
    assert r["rel_res"] <= demo.RES_BOUND and r["pinv_err"] <= demo.PINV_BOUND
    assert float(np.abs(xd - xh).max() / np.abs(xh).max()) <= 1e-4


# ---------------------------------------------------------------------------
# the distribution's jit sites

@pytest.fixture(scope="module")
def world():
    w = dist_world()
    w.ring_calls = dist_schur_run(w)[1]
    return w


LAYOUTS = ("one group halo", "one group all_gather", "two groups peer halo",
           "two groups peer all_gather", "two groups chunk")
TOL = {"float64": 1e-12, "float32": 1e-4}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_p512_cells(dt, layout, world):
    """DistPrec poisson2d(512) eager against replayed on one group (the
    sweep) and two groups of the card (the peer sweep, the chunk form)."""
    from hifir_tpu_torch.parallel import DistPrec

    dp = {"one group halo": world.dps[dt],
          "two groups peer halo": world.dps_peer[(dt, "halo")],
          "two groups peer all_gather": world.dps_peer[(dt, "all_gather")],
          "two groups chunk": world.dps2[dt]}.get(layout)
    if dp is None:
        dp = DistPrec.from_host(world.mesh, world.P, dtype=np.dtype(dt),
                                chunk=DIST_CHUNK, max_halo_chunks=128,
                                halo=False)
    got = dist_graph_cell(dp, lambda: dp.solve(world.b),
                          ref=torch.as_tensor(world.xh), tol=TOL[dt])
    kernel = ("sweep" if layout.startswith("one") else
              "K10a" if layout.endswith("chunk") else "peer")
    assert got[kernel] > 0


def test_interleaved_peer_solves(world):
    """Four eager and four replayed peer-form solves interleaved, every
    wait within the deadline: all bit-equal."""
    dp = world.dps_peer[("float64", "halo")]
    xs = []
    for _ in range(4):
        for on in (False, True):
            dp.graphs = on
            xs.append(dp.solve(world.b))
            sync_all()
    dp.graphs = True
    assert all(same(x, xs[0]) for x in xs)


@pytest.mark.parametrize("layout", ["one group halo", "one group all_gather",
                                    "two groups peer halo",
                                    "two groups peer all_gather",
                                    "two groups chunk halo",
                                    "two groups chunk all_gather"])
def test_p64_cells(layout, world):
    form = "halo" if layout.endswith("halo") else "all_gather"
    dp = (world.p64[form] if layout.startswith("one") else
          world.p64_chunk[form] if "chunk" in layout else
          world.p64_peer[(form, "float64")])
    dist_graph_cell(dp, lambda: dp.solve(world.b64),
                    ref=torch.as_tensor(world.xh64), tol=1e-12)


def test_ir_step_cell(world):
    from hifir_tpu_torch.parallel import make_sharded_ir_step

    n = world.A.nrows
    step = make_sharded_ir_step(world.mesh24, n)
    B = torch.as_tensor(world.draws["B4"], dtype=torch.float64,
                        device="cuda")
    B[n:] = 0
    X0 = torch.zeros_like(B)
    dist_graph_cell(world.mesh24, lambda: step(
        world.Ae, world.single.levels, world.single.tail, X0, B))


def test_halo_spmv_cell(world):
    from hifir_tpu_torch.parallel import build_halo_spmv, halo_spmv

    H = build_halo_spmv(world.mesh, world.A)
    rng = np.random.default_rng(SEED["dist_graphs"])
    xpad = torch.as_tensor(rng.standard_normal(H.nb * DIST_RANKS),
                           dtype=torch.float64, device="cuda")
    xpad[world.A.nrows:] = 0
    dist_graph_cell(world.mesh, lambda: halo_spmv(H, xpad))


def test_ring_step_cell(world):
    """The ring's step on the largest tail of the dist_schur factorize."""
    from hifir_tpu_torch.parallel import make_mesh
    from hifir_tpu_torch.parallel import schur

    _, L_E, d, U_F = max(world.ring_calls, key=lambda c: c[1].nrows)
    rmesh = make_mesh(device="cuda")
    ring, uf_idx, uf_val = schur.ring_operands(L_E, d, U_F, rmesh)
    ring_step = graphs.jit(rmesh, schur._ring_step)
    got = dist_graph_cell(rmesh, lambda: ring_step(ring, uf_idx, uf_val))
    assert got["K10b"] > 0


def test_dist_schur_rings_replayed(world):
    """The dist_schur=1 factorize with its rings eager and replayed: levels
    and tails equal to each other and to the host Schur's, the same K10b
    launches."""
    from hifir_tpu_torch.parallel import make_mesh
    from hifir_tpu_torch.parallel import schur

    ring_fn = schur.schur_spgemm_ring
    outs, k10b = {}, {}
    for on in (False, True):
        def over(C, L_E, d, U_F, mesh=None, device="cuda", on=on):
            m = make_mesh(device=device)
            m.graphs = on
            return ring_fn(C, L_E, d, U_F, mesh=m)

        schur.schur_spgemm_ring = over
        try:
            outs[on], per = dist_count(lambda: ht.HIF().factorize(
                world.Ac, ht.Options(dist_schur=1, **world.base),
                device="cuda"))
        finally:
            schur.schur_spgemm_ring = ring_fn
        k10b[on] = per["K10b"]
    lv = [[(p.m, p.n) for p in outs[on].precs] for on in (False, True)]
    assert lv[0] == lv[1] == [(p.m, p.n) for p in world.Ph.precs]
    tails = [outs[on].precs[-1].dense_matrix for on in (False, True)]
    assert all(t is None for t in tails) or np.array_equal(*tails)
    if world.Ph.precs[-1].dense_matrix is not None:
        dh = world.Ph.precs[-1].dense_matrix
        assert float(np.abs(tails[1] - dh).max() / np.abs(dh).max()) <= 1e-12
    assert k10b[False] == k10b[True] > 0


def test_dryrun_cell():
    """dryrun_multichip(8)'s asserts, then its DistPrec eager against
    replayed, within 1e-8 of the host."""
    from hifir_tpu_torch.entry import dryrun_multichip

    r, _ = dist_count(lambda: dryrun_multichip(8))
    dd = r["dist"]
    ones = np.ones(dd.levels[0].n)
    dist_graph_cell(dd, lambda: dd.solve(ones),
                    ref=torch.as_tensor(r["x_host"]), tol=1e-8)
