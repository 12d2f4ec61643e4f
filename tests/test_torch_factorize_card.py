"""The port's own factorize to the M-solve on the card, and K8 (the dense
tail's device QRCP, ``csrc/kernels.cu:qrcp_kernel``).

- Factorize: convdiff2d(128) on the numpy anchors equal to the checked-in
  fixture (patterns exactly, values 1e-12); poisson2d(256) with bench.py's
  options on the anchors, packed ``auto`` f32 and f64 and ``dense_inv=0``
  f32, solved forward and adjoint at 128 right-hand sides against the
  port's plain f64 CPU solve (1e-4 / 1e-10) with K1 and K2 launched as the
  packs' forms say (the ``auto`` packs launch K2 on level 0), and refined
  by HIFIR nirs = 4 with A = BSR(poisson2d(256)).
- K8 against its plain version (the eager loop) on the card, f64 and f32:
  the fixtures' tails, a 40x40 rank-25 matrix, seeded Gaussian n = 1, 2,
  33, 736, 2000 and an 8x8 tie set, each launch under
  ``torch.cuda.set_sync_debug_mode("error")`` and counted; pivots equal
  (f32: up to a certified tie at f32 precision), Q and R within 1e-12 /
  1e-5 (or twice the plain version's own f32 distance from the f64
  factors), |QR - AP| and |Q^T Q - I| within 1e-13 / 1e-4; on the fixtures
  pivots equal to geqp3's and the rank to the host's.  The layouts, a grid
  that cannot be co-resident refused, the "global_x" layout forced, f64
  n = 14465 once, the K8 path (``tail_on_device``, ``device_tail=1``), the
  complex tail's host fallback and the tail's rank rule.

Every input is drawn from ``default_rng(3)`` in one fixed order
(:func:`draws`).  Every test needs an NVIDIA GPU and skips without one; on
the card: ``python3 -m pytest tests/test_torch_factorize_card.py -q
--noconftest``.
"""

import contextlib
import functools
import types

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import hifir_tpu_torch as ht
from card_common import (CONVDIFF, CONVDIFF_C, FIXTURE, FIXTURE_OPTS, NRHS,
                         SEED, counted, first_diff, host_rel, qr_dist,
                         rel_diff, skip_without_card, solve_forms,
                         want_launches)
from hifir_tpu_torch.models.problems import convdiff2d, poisson2d
from hifir_tpu_torch.ops.bsr_spmv import bsr_from_csr
from hifir_tpu_torch.ops.spmv import ell_matvec_mrhs
from hifir_tpu_torch.ops.trsv import TrsvSchedule
from hifir_tpu_torch.small_scale.dense import DeviceQRCP
from hifir_tpu_torch.small_scale.qrcp_device import (qrcp_device,
                                                     qrcp_device_cuda,
                                                     qrcp_device_plain,
                                                     qrcp_plan, qrcp_rank)

pytestmark = pytest.mark.card


@pytest.fixture(scope="module", autouse=True)
def card():
    skip_without_card()


# K8's seeded Gaussian matrices, beside the fixtures' tails and the tie set
K8_RANDOM = (1, 2, 33, 736, 2000)
K8_NAMES = (("frozen", "convdiff", "rank25")
            + tuple(f"random{n}" for n in K8_RANDOM)
            + ("identity8", "permutation8", "equal_columns8", "zero_column8",
               "zero8"))
K8_TOL = {"float64": 1e-12, "float32": 1e-5}
# the factorization's own gates: |QR - AP| / |A| and |Q^T Q - I|
K8_RESIDUAL = {"float64": 1e-13, "float32": 1e-4}
# the matrices that also run in the "global_x" layout, forced
K8_FORCED = ("random33", "random736")
# the first f64 n whose x, map and inverse leave shared memory on 132 SMs
# ("global_x"); its gates (n eps ~ 1.6e-12 with margin: the backward error
# of Householder QR grows with n)
K8_LARGE = 14465
K8_LARGE_TOL = 1e-11
# bench.py's poisson2d(256) leg
BENCH_OPTS = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5,
                  kappa_d=5, verbose=0)
DTYPES = {"float64": torch.float64, "float32": torch.float32}
PACKS = (("auto", "float32"), ("auto", "float64"), (0, "float32"))


def deficient_tail(kind: str, n: int = 40, rank: int = 25, seed: int = 0):
    """A one-level preconditioner that is all dense tail (m = 0): an n x n
    matrix of rank ``rank`` (``tests/test_device.py``'s 40x40 rank-25 one
    for QRCP, a symmetric one of that rank for SYEIG)."""
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((n, rank))
    D = (U @ np.diag(rng.uniform(1.0, 2.0, rank)) @ U.T if kind == "syeig"
         else U @ rng.standard_normal((rank, n)))
    pay = {"nlevels": np.int64(1), "stats": np.zeros(1),
           "l0_mn": np.array([0, n]), "l0_dense": D,
           "l0_dense_kind": np.array(kind), "l0_d": np.empty(0),
           "l0_s": np.ones(n), "l0_t": np.ones(n)}
    for f, rows, cols in (("L_B", 0, 0), ("U_B", 0, 0), ("E", n, 0),
                          ("F", 0, n)):
        pay.update({f"l0_{f}_indptr": np.zeros(rows + 1, np.int64),
                    f"l0_{f}_indices": np.empty(0, np.int32),
                    f"l0_{f}_data": np.empty(0),
                    f"l0_{f}_shape": np.array([rows, cols])})
    for f in ("p", "p_inv", "q", "q_inv"):
        pay[f"l0_{f}"] = np.arange(n)
    return ht.HIF(ht.prec_from_arrays(pay))


@pytest.fixture(scope="module")
def draws():
    """Every input of the file from ``default_rng(3)``, in its order: the
    poisson2d(256) right-hand sides, K8's matrices (name, A, pivot positions
    compared, rank), the K8 path's right-hand sides (the two fixtures, then
    convdiff2d(128)), the rank rule's (QRCP, then SYEIG) and the seed of
    the large K8 matrix."""
    rng = np.random.default_rng(SEED["factorize"])
    out = types.SimpleNamespace()
    out.B = rng.standard_normal((poisson2d(256).nrows, NRHS))
    mats = [(name, ht.load_prec(path).precs[-1].dense_matrix, None, None)
            for name, path in (("frozen", FIXTURE), ("convdiff", CONVDIFF))]
    # the rank-25 matrix's 25 leading positions: past the rank the choice
    # falls among rounding noise
    mats.append(("rank25", deficient_tail("qrcp").precs[-1].dense_matrix,
                 25, 25))
    mats += [(f"random{n}", rng.standard_normal((n, n)), None, None)
             for n in K8_RANDOM]
    B = rng.standard_normal((8, 8))
    eq, zc = B.copy(), B.copy()
    eq[:, 5] = eq[:, 2]
    zc[:, 3] = 0.0
    # the tie set: every norm ties at every step (identity, permutation);
    # past the rank the norms are exact zeros or one column is left
    mats += [("identity8", np.eye(8), None, None),
             ("permutation8", np.eye(8)[rng.permutation(8)], None, None),
             ("equal_columns8", eq, None, 7), ("zero_column8", zc, None, 7),
             ("zero8", np.zeros((8, 8)), None, 0)]
    out.mats = {name: (A, A.shape[0] if lead is None else lead,
                       A.shape[0] if rank is None else rank)
                for name, A, lead, rank in mats}
    assert tuple(out.mats) == K8_NAMES
    out.path_B = [rng.standard_normal((ht.load_prec(p).precs[0].n, NRHS))
                  for p in (FIXTURE, CONVDIFF)]
    out.path_B.append(rng.standard_normal((convdiff2d(128).nrows, NRHS)))
    out.rank_B = {kind: rng.standard_normal((40, NRHS))
                  for kind in ("qrcp", "syeig")}
    out.large_seed = int(rng.integers(2**62))
    return out


# ---------------------------------------------------------------------------
# factorize

@contextlib.contextmanager
def anchors():
    """The port's factorize on its numpy anchors (RCM, the numpy MC64, the
    Crout anchors), its native host library switched off: how the JAX
    package wrote the checked-in fixtures, without its library."""
    from hifir_tpu_torch.pre import _native

    load = _native._load
    _native._load = lambda: None
    try:
        yield
    finally:
        _native._load = load


def levels_equal(P, R) -> None:
    """The port's factorization ``P`` equal to the reference ``R`` level by
    level, as tests/test_torch_factorize.py holds it: sizes, permutations
    and patterns exactly, values within 1e-12 of their largest magnitude,
    the tail's kind and rank."""
    assert [(p.m, p.n) for p in P.precs] == [(p.m, p.n) for p in R.precs]

    def close(a, b, what):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, what
        if a.size:
            d = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
            assert d <= 1e-12, f"{what}: rel diff {d:.3e}"

    for i, (pp, rp) in enumerate(zip(P.precs, R.precs)):
        for f in ("p", "q", "p_inv", "q_inv"):
            assert np.array_equal(getattr(pp, f), getattr(rp, f)), \
                f"level {i} {f}"
        for f in ("L_B", "U_B", "E", "F"):
            a, b = getattr(pp, f), getattr(rp, f)
            assert (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
                    and np.array_equal(a.indices, b.indices)), \
                f"level {i} {f}: pattern"
            close(a.data, b.data, f"level {i} {f}")
        for f in ("d", "s", "t"):
            close(getattr(pp, f), getattr(rp, f), f"level {i} {f}")
    pl, rl = P.precs[-1], R.precs[-1]
    assert (pl.dense_matrix is None) == (rl.dense_matrix is None)
    if rl.dense_matrix is not None:
        close(pl.dense_matrix, rl.dense_matrix, "dense tail")
        pd, rd = pl.dense_solver, rl.dense_solver
        assert (pd.kind, pd.rank) == (rd.kind, rd.rank)


def test_factorize_convdiff_equals_fixture():
    with anchors():
        Pc = ht.HIF().factorize(convdiff2d(128), ht.Options(**FIXTURE_OPTS))
    levels_equal(Pc, ht.load_prec(CONVDIFF))


@pytest.fixture(scope="module")
def p256(draws):
    """poisson2d(256) with bench.py's options on the anchors, its packs and
    the CPU references."""
    A = poisson2d(256)
    with anchors():
        P = ht.HIF().factorize(A, ht.Options(**BENCH_OPTS))
    ref_pack = P.to_device(dtype=np.float64, device="cpu", dense_inv=0)
    ref_pack.pack_transpose(P.precs)
    packs = {}
    for di, dt in PACKS:
        dp = packs[(di, dt)] = P.to_device(dtype=np.dtype(dt), dense_inv=di)
        dp.pack_transpose(P.precs)
    return types.SimpleNamespace(
        A=A, P=P, packs=packs,
        ref={t: ref_pack.solve_mrhs(draws.B, trans=t).numpy()
             for t in (False, True)},
        Bd={dt: torch.as_tensor(draws.B, dtype=getattr(torch, dt),
                                device="cuda")
            for dt in ("float32", "float64")})


def test_poisson256_level0_takes_k2(p256):
    """Level 0 is above the blocked-inverse range, so K2 carries the auto
    solve."""
    assert p256.P.precs[0].m > 8 * 2048


@pytest.mark.parametrize("trans", [False, True], ids=["forward", "adjoint"])
@pytest.mark.parametrize("pack", PACKS,
                         ids=lambda p: f"dense_inv={p[0]}-{p[1]}")
def test_poisson256_solve(pack, trans, p256):
    di, dt = pack
    dp = p256.packs[pack]
    n = p256.A.nrows
    X, per, _ = counted(lambda: dp.solve_mrhs(p256.Bd[dt], trans=trans))
    assert bool(torch.isfinite(X).all())
    assert tuple(X.shape) == (n, NRHS)
    d = host_rel(X, p256.ref[trans])
    assert d <= (1e-4 if dt == "float32" else 1e-10), f"{d:.3e}"
    want = want_launches(solve_forms(dp, trans))
    assert {k: per[k] for k in want} == want
    if di == "auto" and not trans:
        lv0 = dp.levels[0]
        assert isinstance(lv0.L, TrsvSchedule) and lv0.L.nchunks > 0
        assert per["K2"] >= 2


def test_poisson256_hifir(p256, draws):
    """HIFIR, f64, A = BSR(poisson2d(256), bs=128): the residual falls every
    step for every column; K7 3 times and K1, K2 four solves' worth."""
    dp = p256.packs[("auto", "float64")]
    Ab = bsr_from_csr(p256.A, bs=128, dtype=np.float64)
    Bt = p256.Bd["float64"]
    Xs = [ht.ir_apply(Ab, dp, Bt, k) for k in range(1, 4)]
    X4, got, _ = counted(lambda: ht.ir_apply(Ab, dp, Bt, 4))
    Xs.append(X4)
    per = want_launches(solve_forms(dp, False))
    assert {k: got[k] for k in ("K7", "K1", "K2")} == dict(
        K7=3, K1=4 * per["K1"], K2=4 * per["K2"])
    assert got["K1"] > 0 and got["K2"] > 0
    res = np.array([torch.linalg.vector_norm(
        Bt - ell_matvec_mrhs(Ab, Xk), dim=0).cpu().numpy() for Xk in Xs])
    assert np.all(res[1:] < res[:-1])


# ---------------------------------------------------------------------------
# K8

def near_tie(A64, prefix, a: int, b: int, dtype: str):
    """Whether columns a and b were a tie at ``dtype``'s precision after the
    pivots ``prefix``: their residual norms^2 once A[:, prefix] is
    projected out, computed in f64 on the card, differ by more than 1e-12
    (no exact tie, which the position rule decides) and less than
    delta = n eps(dtype) n / (n - s) (the downdated norms' drift after s
    steps, relative to the trailing norms), and both lie within delta of
    the largest.  Returns (verdict, relative gap, delta)."""
    n, s = A64.shape[0], len(prefix)
    delta = n * float(np.finfo(dtype).eps) * n / (n - s)
    rest = np.setdiff1d(np.arange(n), prefix)
    Ar = A64[:, torch.as_tensor(rest, device=A64.device)]
    if s:
        Qs = torch.linalg.qr(A64[:, torch.as_tensor(prefix,
                                                    device=A64.device)])[0]
        Ar = Ar - Qs @ (Qs.T @ Ar)
    r2 = (Ar * Ar).sum(0)
    top = float(r2.max())
    ra = float(r2[int(np.flatnonzero(rest == a)[0])])
    rb = float(r2[int(np.flatnonzero(rest == b)[0])])
    gap = abs(ra - rb) / max(ra, rb, 1e-300)
    ok = (1e-12 < gap < delta and ra >= (1 - delta) * top
          and rb >= (1 - delta) * top)
    return ok, gap, delta


@pytest.fixture(scope="module")
def plain64(draws):
    """The plain version's f64 factors of each matrix, on the card."""
    @functools.cache
    def of(name):
        D = draws.mats[name][0]
        return qrcp_device_plain(torch.as_tensor(D, dtype=torch.float64,
                                                 device="cuda"))
    return of


def k8_check(name, draws, plain64, dt, layout=None):
    """One K8 factorization in dtype ``dt`` on the card, in ``layout``
    (default: the plan's), against the plain version's."""
    D, lead, rank = draws.mats[name]
    dname = str(dt).removeprefix("torch.")
    n = D.shape[0]
    Ad = torch.as_tensor(D, dtype=dt, device="cuda")
    torch.cuda.synchronize()
    k0, p0 = qrcp_device_cuda.launches, qrcp_device_plain.calls
    torch.cuda.set_sync_debug_mode("error")
    try:
        F = (qrcp_device(Ad) if layout is None
             else qrcp_device_cuda(Ad, layout=layout))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (qrcp_device_cuda.launches == k0 + 1
            and qrcp_device_plain.calls == p0), "not one kernel launch"
    Fp = qrcp_device_plain(Ad)
    Q, R, piv = F
    pk, pp = piv.cpu().numpy(), Fp[2].cpu().numpy()
    s1 = first_diff(pk, pp, lead)
    m = min(s1, rank)
    if s1 < lead:
        ok, gap, delta = (near_tie(torch.as_tensor(D, device="cuda"),
                                   pk[:s1], int(pk[s1]), int(pp[s1]), dname)
                          if dt == torch.float32 else (False, None, None))
        assert ok, (f"pivot {s1} differs from the plain version's ({pk[s1]}"
                    f" / {pp[s1]}; f64 residual gap {gap}, delta {delta})")
    tol = K8_TOL[dname]
    dq, dr, _ = qr_dist(F, Fp, m)
    if dt == torch.float32 and max(dq, dr) > tol:
        # beyond 1e-5 (the Gaussian matrices' n kappa eps): the kernel's
        # and the plain version's f32 factors against the plain f64 ones,
        # where all three pivot orders agree
        F64 = plain64(name)
        p64 = F64[2].cpu().numpy()
        mm = min(m, first_diff(pp, p64, lead), first_diff(pk, p64, lead))
        k64 = max(qr_dist(F, F64, mm)[:2])
        p32 = max(qr_dist(Fp, F64, mm)[:2])
        assert k64 <= max(tol, 2 * p32), (
            f"{k64:.2e} from the f64 factors, the plain version {p32:.2e}")
    else:
        assert dq <= tol and dr <= tol, (
            f"Q {dq:.2e} or R {dr:.2e} above {tol:.1e}")
    A64 = Ad.double()
    res = float((Q.double() @ R.double() - A64[:, piv]).abs().max()
                / max(float(A64.abs().max()), 1e-300))
    orth = float((Q.double().T @ Q.double() - torch.eye(
        n, dtype=torch.float64, device="cuda")).abs().max())
    rtol = K8_RESIDUAL[dname]
    assert res <= rtol and orth <= rtol, (
        f"residual {res:.2e} or orthogonality {orth:.2e} above {rtol:.0e}")
    if name in ("frozen", "convdiff") and dt == torch.float64:
        host = ht.load_prec(FIXTURE if name == "frozen"
                            else CONVDIFF).precs[-1].dense_solver
        _, _, lpiv = sla.qr(D, pivoting=True, mode="economic")
        assert np.array_equal(pk, lpiv), "pivots differ from geqp3's"
        assert qrcp_rank(R) == host.rank


@pytest.mark.parametrize("name", K8_NAMES)
@pytest.mark.parametrize("dname", list(DTYPES))
def test_k8_equals_plain(dname, name, draws, plain64):
    k8_check(name, draws, plain64, DTYPES[dname])


@pytest.mark.parametrize("name", K8_FORCED)
@pytest.mark.parametrize("dname", list(DTYPES))
def test_k8_global_x_forced_equals_plain(dname, name, draws, plain64):
    k8_check(name, draws, plain64, DTYPES[dname], layout="global_x")


def test_k8_layouts(draws):
    """The fixtures' tails take shared memory, n = 2000 global memory."""
    assert qrcp_plan(draws.mats["frozen"][0].shape[0],
                     torch.float64)["layout"] == "shared"
    assert qrcp_plan(2000, torch.float64)["layout"] == "global"


def test_k8_refuses_grid_not_coresident(draws):
    """A grid that cannot be co-resident is an error, never a smaller
    grid."""
    A = torch.as_tensor(draws.mats["random2000"][0], dtype=torch.float32,
                        device="cuda")
    with pytest.raises(RuntimeError):
        qrcp_device_cuda(A, cols_per_cta=1)


@pytest.mark.parametrize("which", [0, 1], ids=["frozen", "convdiff"])
def test_k8_tail_on_device(which, draws):
    """The auto f64 M-solve of a ``tail_on_device`` pack, whose tail K8
    factorizes, within 1e-10 of the host-tail pack's."""
    M = ht.load_prec((FIXTURE, CONVDIFF)[which])
    B = torch.as_tensor(draws.path_B[which], device="cuda")
    calls, k0 = qrcp_device.calls, qrcp_device_cuda.launches
    dpd = M.to_device(dtype=np.float64, tail_on_device=True)
    torch.cuda.synchronize()
    assert qrcp_device.calls == calls + 1, "tail_on_device did not run K8"
    assert qrcp_device_cuda.launches > k0
    dph = M.to_device(dtype=np.float64, tail_on_device=False)
    assert rel_diff(dpd.solve_mrhs(B), dph.solve_mrhs(B)) <= 1e-10


def test_k8_device_tail_factorize(draws):
    """HIF.factorize(convdiff2d(128)) with device_tail=1 against 0: the
    tail's rank and the M-solve (1e-8)."""
    Ac = convdiff2d(128)
    k0 = qrcp_device_cuda.launches
    fact = {dtail: ht.HIF().factorize(Ac, ht.Options(
        **dict(FIXTURE_OPTS, device_tail=dtail))) for dtail in (1, 0)}
    torch.cuda.synchronize()
    dd, dh = (fact[k].precs[-1].dense_solver for k in (1, 0))
    B = torch.as_tensor(draws.path_B[2], device="cuda")
    d = rel_diff(fact[1].to_device(dtype=np.float64).solve_mrhs(B),
                 fact[0].to_device(dtype=np.float64).solve_mrhs(B))
    assert isinstance(dd, DeviceQRCP) and dd.rank == dh.rank and d <= 1e-8
    assert qrcp_device_cuda.launches > k0


def truncated_host_solve(ds, B, k: int) -> np.ndarray:
    """The dense tail's solve on the host keeping k columns (QRCP) or the
    k largest eigenvalues (SYEIG): what a rank rule that keeps k computes."""
    if ds.kind == "qrcp":
        X = np.zeros_like(B)
        X[ds.jpvt[:k]] = np.linalg.solve(ds.R[:k, :k], ds.Q[:, :k].T @ B)
        return X
    idx = np.argsort(-np.abs(ds.w))[:k]
    V = ds.V[:, idx]
    return V @ ((V.T @ B) / ds.w[idx][:, None])


@pytest.mark.parametrize("trans", [False, True], ids=["forward", "adjoint"])
@pytest.mark.parametrize("kind", ["qrcp", "syeig"])
def test_tail_rank_rule(kind, trans, draws):
    """On a 40x40 rank-25 tail (r = rank + 1 < 40, where the rule that kept
    min(r, nm) columns differs): r = rank + 1 gives r = 0's solve (1e-12)
    and the host's truncated solve at the rank (1e-10), f64, 128 RHS."""
    H = deficient_tail(kind)
    ds = H.precs[-1].dense_solver
    dp = H.to_device(dtype=np.float64)
    dp.pack_transpose(H.precs)
    r, nm = dp.tail.rank, dp.tail.Q.shape[0]
    assert r + 1 < nm, f"the {kind} tail is not deficient (rank {r} of {nm})"
    B = draws.rank_B[kind]
    Bd = torch.as_tensor(B, device="cuda")
    X = dp.solve_mrhs(Bd, trans=trans, r=r + 1)
    d0 = rel_diff(X, dp.solve_mrhs(Bd, trans=trans, r=0))
    # the adjoint of a QRCP tail solves with A^T = P R^T Q^T
    if trans and kind == "qrcp":
        ref = ds.Q[:, :r] @ np.linalg.solve(ds.R[:r, :r].T, B[ds.jpvt[:r]])
    else:
        ref = truncated_host_solve(ds, B, r)
    dh = rel_diff(X, torch.as_tensor(ref, device="cuda"))
    assert d0 <= 1e-12 and dh <= 1e-10, f"{d0:.3e} / {dh:.3e}"


def test_k8_large(draws):
    """K8 once at n = 14465 in f64 on a seeded Gaussian A made on the card,
    in the "global_x" layout the plan picks there: one launch and no host
    sync; |A[:, piv] - Q R| / |A| and |Q^T Q - I| within 1e-11 (TF32 off);
    piv a permutation whose first entry is A's column of largest norm.
    The plain route (~3 ms a column step) is not run."""
    n = K8_LARGE
    assert qrcp_plan(n, torch.float64)["layout"] == "global_x"
    g = torch.Generator(device="cuda")
    g.manual_seed(draws.large_seed)
    A = torch.randn((n, n), generator=g, dtype=torch.float64, device="cuda")
    torch.cuda.synchronize()
    k0, p0 = qrcp_device_cuda.launches, qrcp_device_plain.calls
    torch.cuda.set_sync_debug_mode("error")
    try:
        Q, R, piv = qrcp_device(A)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (qrcp_device_cuda.launches == k0 + 1
            and qrcp_device_plain.calls == p0), "not one launch"
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = float((A[:, piv] - Q @ R).abs().max() / A.abs().max())
        Q = Q.T @ Q
        Q.diagonal().sub_(1.0)
        orth = float(Q.abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    p = piv.cpu().numpy()
    first = int(torch.argmax((A * A).sum(0)))
    del A, Q, R
    torch.cuda.empty_cache()
    assert res <= K8_LARGE_TOL and orth <= K8_LARGE_TOL, (res, orth)
    assert np.array_equal(np.sort(p), np.arange(n)) and p[0] == first


def test_complex_tail_takes_host_qrcp():
    """The complex fixture's 25x25 tail takes the host QRCP."""
    Dz = ht.load_prec(CONVDIFF_C).precs[-1].dense_matrix
    calls = qrcp_device.calls
    dz = DeviceQRCP("cuda")
    dz.factorize(Dz)
    assert qrcp_device.calls == calls and dz.rank == Dz.shape[0]
