"""The port's jit layer (``hifir_tpu_torch/graphs.py``) and the
device-resident GMRES cycles, on the CPU.

The cycles run as the JAX package's jitted cycles run on the CPU: the port's
single-RHS cycle (in segments) against JAX ``_restart_cycle`` and its
batched cycle against JAX ``_restart_cycle_mrhs`` in f64, the same steps,
the residual estimate within 1e-12 relative and x within 1e-10 of max|x|.
A complex single-RHS cycle is held to the port's earlier host cycle (the
numpy Givens step below, which conjugates as this one does; the JAX
single-RHS rotation does not) within 1e-12.

The cache's logic runs on the CPU with the CUDA backend swapped for
:class:`EagerGraphs`, a stand-in whose capture runs the program on copies of
its arguments (so the launch counters move as they do while a graph is
captured) and whose replay runs it again on the static arguments with the
counters held (a graph's replay moves no Python counter).  Sizes are small:
convdiff2d(12) with ``dense_inv`` 0 (the plain level scan), 20 (the blocked
form) and "auto".
"""

import copy

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax.numpy as jnp

from hifir_tpu.alg.prec import DevicePrec as JDevicePrec
from hifir_tpu.api import HIF as JHIF
from hifir_tpu.models import convdiff2d, poisson2d
from hifir_tpu.ops import spmv as jspmv
from hifir_tpu.options import Options
from hifir_tpu.solvers.gmres import _restart_cycle as j_restart_cycle
from hifir_tpu.solvers.gmres import _restart_cycle_mrhs as j_cycle_mrhs
from hifir_tpu.solvers.gmres import (fgmres_hifir_device, gmres_hif_device,
                                     gmres_mrhs_device)
from hifir_tpu.utils.serialize import save_prec

import hifir_tpu_torch as ht
from hifir_tpu_torch import graphs
from hifir_tpu_torch.alg.prec import (DevicePrec, prec_prod_mrhs,
                                      prec_solve_mrhs)
from hifir_tpu_torch.ops import bsr_spmv, spmv, trsv
from hifir_tpu_torch.ops.spmv import sliced_ell_from_csr
from hifir_tpu_torch.ops.trsv import TrsvBlockDense, TrsvSchedule
from hifir_tpu_torch.parallel import (DistPrec, PartitionedHIF, make_mesh,
                                      make_sharded_ir_step, shard_ell_rows)
from hifir_tpu_torch.parallel.partition import DevicePartitionedPrec
from hifir_tpu_torch.solvers import gmres
from hifir_tpu_torch.solvers.ir import ir_apply_mrhs

from test_torch_complex import _OPERATORS, _crandn
from test_torch_prec import _carry, _port, _rel

CPU = "cpu"
OPTS = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5, kappa_d=5,
            verbose=0, dense_thres=30)
DENSE_INV = [0, 20, "auto"]


class _Fake:
    """A stand-in graph: the program, its static arguments and output."""

    def __init__(self, fn, args, out):
        self.fn, self.args, self.out = fn, args, out


def _copy_into(dst, src):
    if torch.is_tensor(dst):
        dst.copy_(src)
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)


class EagerGraphs:
    """Stand-in for :class:`graphs.CudaGraphs` on the CPU (see the module
    docstring); counts its captures and replays."""

    def __init__(self, device):
        self.device = device
        self.captures = self.replays = 0

    def warm(self, fn, args):
        return fn(*args)

    def capture(self, fn, args):
        self.captures += 1
        out = fn(*copy.deepcopy(args))
        return _Fake(fn, args, out), out

    def replay(self, graph):
        self.replays += 1
        held = graphs.read_counters()
        out = graph.fn(*graph.args)
        graphs._set_counters(held)
        _copy_into(graph.out, out)


class FailingGraphs(EagerGraphs):
    """A backend whose every capture fails."""

    def capture(self, fn, args):
        raise RuntimeError("operation not permitted when stream is capturing")


@pytest.fixture
def stand_in(monkeypatch):
    """Every CPU pack with ``graphs`` on runs through the cache."""
    monkeypatch.setitem(graphs.BACKENDS, "cpu", EagerGraphs)


@pytest.fixture(scope="module")
def cd12(tmp_path_factory):
    A = convdiff2d(12)
    M = JHIF().factorize(A, Options(**OPTS))
    precs = _carry(M, tmp_path_factory.mktemp("cd12"))
    return A, M, precs


def _packs(cd12, dense_inv):
    A, M, precs = cd12
    dp = DevicePrec.from_host(precs, dense_inv=dense_inv, device=CPU)
    jdp = JDevicePrec.from_host(M.precs, dense_inv=dense_inv)
    return dp, jdp


def test_dense_inv_reaches_each_form(cd12):
    forms = {di: {type(f) for lvl in _packs(cd12, di)[0].levels
                  for f in (lvl.L, lvl.U)} for di in DENSE_INV}
    assert TrsvSchedule in forms[0]
    assert TrsvBlockDense in forms[20]


# ---------------------------------------------------------------------------
# the single-RHS cycle against JAX _restart_cycle


def _cycle(A, dp, b, x, rtol_bnrm, m, seg, nirs=1, r=None):
    w = gmres._Cycle.new(b.shape[0], m, dp.dtype, dp.device)
    w.b.copy_(torch.as_tensor(b))
    w.xo.copy_(torch.as_tensor(x))
    w.rtol.fill_(rtol_bnrm)
    res, jused = gmres._restart_cycle(A, dp, None, w, nirs, r, seg)
    return w, res, jused


@pytest.mark.parametrize("dense_inv", DENSE_INV)
@pytest.mark.parametrize("rtol", [1e-2, 1e-14])
@pytest.mark.parametrize("seg", [1, 5, 8])
def test_single_cycle_matches_jax(cd12, dense_inv, rtol, seg):
    """One GMRES(8) cycle from a nonzero x: converged inside the cycle
    (rtol 1e-2) and run to m (1e-14)."""
    A, M, _ = cd12
    dp, jdp = _packs(cd12, dense_inv)
    rng = np.random.default_rng(5)
    b = rng.standard_normal(A.nrows)
    x = 0.1 * rng.standard_normal(A.nrows)
    At = sliced_ell_from_csr(_port(A), device=CPU)
    Aj = jspmv.sliced_ell_from_csr(A)
    thr = rtol * np.linalg.norm(b)
    w, res, jused = _cycle(At, dp, b, x, thr, 8, seg)
    xj, resj, jj = j_restart_cycle(Aj, jdp.levels, jdp.tail, jnp.asarray(b),
                                   jnp.asarray(x), thr, 8)
    assert jused == int(jj) and (jused < 8) == (rtol == 1e-2)
    assert abs(res - float(resj)) <= 1e-12 * float(resj)
    assert _rel(w.xo, np.asarray(xj)) <= 1e-10


@pytest.mark.parametrize("dense_inv", DENSE_INV)
@pytest.mark.parametrize("nirs,rank", [(2, False), (4, True)])
def test_single_cycle_nirs_rank_matches_jax(cd12, dense_inv, nirs, rank):
    """The FGMRES cycle: HIFIR inside, with the rank override set to the
    tail's rank (as ``test_torch_surface.py``'s FGMRES test does: a rank
    below it makes M singular here, and the stagnating cycle then amplifies
    the two packages' rounding to 1e-3).  Converged to 1e-9, the residual
    estimate is rounding-sized against ||b||, so it is held within
    1e-12 ||b|| (its relative spread is up to 5e-11 at nirs = 4)."""
    A, M, _ = cd12
    dp, jdp = _packs(cd12, dense_inv)
    b = np.random.default_rng(6).standard_normal(A.nrows)
    r = dp.tail.rank if rank else None
    At = sliced_ell_from_csr(_port(A), device=CPU)
    Aj = jspmv.sliced_ell_from_csr(A)
    thr = 1e-9 * np.linalg.norm(b)
    w, res, jused = _cycle(At, dp, b, np.zeros_like(b), thr, 6, 5, nirs, r)
    xj, resj, jj = j_restart_cycle(Aj, jdp.levels, jdp.tail, jnp.asarray(b),
                                   jnp.zeros(A.nrows), thr, 6, nirs,
                                   r=jnp.int32(r) if rank else None)
    assert jused == int(jj) and 1 < jused < 6
    assert abs(res - float(resj)) <= 1e-12 * np.linalg.norm(b)
    assert _rel(w.xo, np.asarray(xj)) <= 1e-10


def _state(w):
    return {f: getattr(w, f).clone() for f in w.__dataclass_fields__}


def test_masked_steps_leave_the_state_bit_equal(cd12):
    """After ``done``, further steps (and the finish) change no bit."""
    A, M, _ = cd12
    dp, _ = _packs(cd12, 20)
    b = np.random.default_rng(7).standard_normal(A.nrows)
    At = sliced_ell_from_csr(_port(A), device=CPU)
    w, res, jused = _cycle(At, dp, b, np.zeros_like(b),
                           1e-2 * np.linalg.norm(b), 12, 1)
    assert bool(w.done) and jused < 10
    before = _state(w)
    gmres._segment(At, dp.levels, dp.tail, 1, None, jused, 12, w)
    for f, t in _state(w).items():
        assert torch.equal(t, before[f]), f
    # one step past done, stepped alone
    gmres._step(At, dp.levels, dp.tail, 1, None, jused + 1, w)
    for f, t in _state(w).items():
        assert torch.equal(t, before[f]), f


@pytest.mark.parametrize("restart,rtol", [(12, 1e-10), (4, 1e-10)])
def test_segment_lengths_give_the_same_run(cd12, monkeypatch, restart, rtol):
    """SEGMENT 1, 5 and m: the same iterations and the same x, bit for
    bit (the masked steps change nothing)."""
    A, M, _ = cd12
    dp, _ = _packs(cd12, 0)
    b = np.random.default_rng(8).standard_normal(A.nrows)
    At = sliced_ell_from_csr(_port(A), device=CPU)
    runs = []
    for seg in (1, 5, restart):
        monkeypatch.setattr(gmres, "SEGMENT", seg)
        runs.append(ht.gmres_hif(At, dp, b, restart=restart, rtol=rtol))
    for x, flag, it in runs[1:]:
        assert (flag, it) == runs[0][1:] and flag == 0
        assert torch.equal(x, runs[0][0])


# ---------------------------------------------------------------------------
# the batched cycle against JAX _restart_cycle_mrhs


@pytest.mark.parametrize("dense_inv", DENSE_INV)
def test_batched_cycle_matches_jax(cd12, dense_inv):
    """One batched GMRES(5) cycle from a nonzero X, with a zero column."""
    A, M, _ = cd12
    dp, jdp = _packs(cd12, dense_inv)
    rng = np.random.default_rng(9)
    B = rng.standard_normal((A.nrows, 4))
    B[:, 2] = 0.0
    X = 0.1 * rng.standard_normal((A.nrows, 4))
    X[:, 2] = 0.0
    At = sliced_ell_from_csr(_port(A), device=CPU)
    Aj = jspmv.sliced_ell_from_csr(A)
    w = gmres._CycleMrhs.new(A.nrows, 4, 5, dp.dtype, dp.device)
    w.B.copy_(torch.as_tensor(B))
    w.X.copy_(torch.as_tensor(X))
    bn = np.linalg.norm(B, axis=0)
    w.bsafe.copy_(torch.as_tensor(np.where(bn > 0, bn, 1)))
    gmres._cycle_mrhs(At, dp.levels, dp.tail, w)
    Xj, resj = j_cycle_mrhs(Aj, jdp.levels, jdp.tail, jnp.asarray(B),
                            jnp.asarray(X), 5)
    ratio = float(np.max(np.asarray(resj) / np.where(bn > 0, bn, 1)))
    assert abs(float(w.stat) - ratio) <= 1e-12 * ratio
    assert _rel(w.X, np.asarray(Xj)) <= 1e-10
    assert not w.X[:, 2].any()


# ---------------------------------------------------------------------------
# complex single RHS against the port's earlier host cycle


def _host_givens(c, cs, sn, g, j):
    for i in range(j):
        t = cs[i] * c[i] + sn[i] * c[i + 1]
        c[i + 1] = -np.conj(sn[i]) * c[i] + np.conj(cs[i]) * c[i + 1]
        c[i] = t
    a, bb = c[j], c[j + 1]
    rho = np.sqrt(abs(a) ** 2 + abs(bb) ** 2)
    cs[j] = np.conj(a) / rho if rho > 0 else 1
    sn[j] = np.conj(bb) / rho if rho > 0 else 0
    c[j], c[j + 1] = rho, 0
    g[j + 1] = -np.conj(sn[j]) * g[j]
    g[j] = cs[j] * g[j]


def _host_cycle(A, dp, b, x, thr, m):
    """The single-RHS cycle with its Hessenberg and rotations on the host
    (numpy), as the port ran it before the device-resident cycle."""
    r = (b - A @ x)
    beta = np.linalg.norm(r)
    V = np.zeros((m + 1, b.size), b.dtype)
    Z = np.zeros((m, b.size), b.dtype)
    V[0] = r / beta
    H = np.zeros((m + 1, m), b.dtype)
    cs, sn, g = (np.zeros(m, b.dtype), np.zeros(m, b.dtype),
                 np.zeros(m + 1, b.dtype))
    g[0] = beta
    j_used = m
    for j in range(m):
        z = prec_solve_mrhs(dp.levels, dp.tail,
                            torch.as_tensor(V[j])[:, None])[:, 0].numpy()
        w = A @ z
        h = np.zeros(m + 1, b.dtype)
        for _ in range(2):
            p = V[:j + 1].conj() @ w
            w = w - p @ V[:j + 1]
            h[:j + 1] += p
        h[j + 1] = np.linalg.norm(w)
        V[j + 1] = w / h[j + 1] if h[j + 1].real > 0 else w
        Z[j] = z
        _host_givens(h, cs, sn, g, j)
        H[:, j] = h
        if abs(g[j + 1]) <= thr:
            j_used = j + 1
            break
    y = sla.solve_triangular(H[:j_used, :j_used], g[:j_used])
    return x + y @ Z[:j_used], abs(g[j_used]), j_used


@pytest.mark.parametrize("name", sorted(_OPERATORS))
@pytest.mark.parametrize("rtol", [1e-3, 1e-14])
def test_complex_single_cycle_matches_host_cycle(tmp_path, name, rtol):
    A = _OPERATORS[name]()
    M = JHIF().factorize(A, Options(**OPTS))
    dp = DevicePrec.from_host(_carry(M, tmp_path), dense_inv=20, device=CPU)
    b = _crandn(np.random.default_rng(10), A.nrows)
    S = A.to_scipy()
    thr = rtol * np.linalg.norm(b)
    At = sliced_ell_from_csr(_port(A), device=CPU)
    w, res, jused = _cycle(At, dp, b, np.zeros_like(b), thr, 8, 5)
    xh, resh, jh = _host_cycle(S, dp, b, np.zeros_like(b), thr, 8)
    assert w.xo.dtype == torch.complex128
    assert jused == jh and abs(res - resh) <= 1e-12 * resh
    assert _rel(w.xo, xh) <= 1e-12


# ---------------------------------------------------------------------------
# the drivers through the cache against the JAX drivers


def _ops(A, op):
    from hifir_tpu.ops.pallas_spmv import bsr_from_csr as jbsr_from_csr

    if op == "bsr":
        return (bsr_spmv.bsr_from_csr(_port(A), bs=64, device=CPU),
                jbsr_from_csr(A, bs=64))
    return (sliced_ell_from_csr(_port(A), device=CPU),
            jspmv.sliced_ell_from_csr(A))


@pytest.mark.parametrize("graphs_on", [True, False])
@pytest.mark.parametrize("op", ["bsr", "sliced_ell"])
def test_gmres_hif_replayed_matches_jax(cd12, stand_in, graphs_on, op):
    A, M, _ = cd12
    dp, jdp = _packs(cd12, "auto")
    dp.graphs = graphs_on
    At, Aj = _ops(A, op)
    b = np.random.default_rng(4).standard_normal(A.nrows)
    xj, flagj, itj = gmres_hif_device(Aj, jdp, jnp.asarray(b), restart=4,
                                      rtol=1e-10)
    for _ in range(2):      # the second run replays every segment
        x, flag, it = ht.gmres_hif(At, dp, b, restart=4, rtol=1e-10)
        assert (flag, it) == (flagj, itj) and flag == 0 and it > 4
        assert _rel(x, xj) <= 1e-8
    assert (dp.graph_cache is not None) == graphs_on
    if graphs_on:
        assert dp.graph_cache.backend.replays > 0


def test_fgmres_hifir_replayed_matches_jax(tmp_path, stand_in):
    A = poisson2d(12)
    M = JHIF().factorize(A, Options(verbose=0, dense_thres=30))
    dp = DevicePrec.from_host(_carry(M, tmp_path), device=CPU)
    jdp = M.to_device(dtype=jnp.float64)
    At, Aj = _ops(A, "sliced_ell")
    b = np.random.default_rng(0).standard_normal(A.nrows)
    xj, flagj, itj = fgmres_hifir_device(Aj, jdp, jnp.asarray(b), restart=3,
                                         rtol=1e-10, rank=jdp.tail.rank)
    for _ in range(2):
        x, flag, it = ht.fgmres_hifir(At, dp, b, restart=3, rtol=1e-10,
                                      rank=dp.tail.rank)
        assert (flag, it) == (flagj, itj) and flag == 0
        assert _rel(x, xj) <= 1e-8
    # a cycle program for each inner count it reached (1, 2, 4, ...)
    nirs = {k[4][2] for k in dp.graph_cache.entries if k[0] is gmres._segment}
    assert nirs == {1 << min(c, 4) for c in range(-(-it // 3))}


@pytest.mark.parametrize("op", ["bsr", "sliced_ell"])
def test_gmres_mrhs_replayed_matches_jax(cd12, stand_in, op):
    A, M, _ = cd12
    dp, jdp = _packs(cd12, "auto")
    At, Aj = _ops(A, op)
    B = np.random.default_rng(0).standard_normal((A.nrows, 6))
    B[:, 3] = 0.0
    Xj, flagj, cyclesj = gmres_mrhs_device(Aj, jdp, jnp.asarray(B),
                                           restart=3, rtol=1e-8)
    for _ in range(2):
        X, flag, cycles = ht.gmres_mrhs(At, dp, B, restart=3, rtol=1e-8)
        assert (flag, cycles) == (flagj, cyclesj) and flag == 0
        assert _rel(X, Xj) <= 1e-8 and not X[:, 3].any()
    assert dp.graph_cache.backend.replays >= 2 * cycles - 1


# ---------------------------------------------------------------------------
# the cache


@pytest.mark.parametrize("dense_inv", DENSE_INV)
def test_replay_equals_eager(cd12, stand_in, dense_inv):
    """Every routed method, first call and replay, equal to the eager pack
    bit for bit on the CPU."""
    A, M, precs = cd12
    dp = DevicePrec.from_host(precs, dense_inv=dense_inv, device=CPU)
    ref = DevicePrec.from_host(precs, dense_inv=dense_inv, device=CPU,
                               graphs=False)
    for p in (dp, ref):
        p.pack_prod_tran(precs)
        p.pack_prod(precs)
    At = sliced_ell_from_csr(_port(A), device=CPU)
    rng = np.random.default_rng(11)
    r = dp.tail.rank - 1
    calls = [
        lambda p, B: p.solve_mrhs(B),
        lambda p, B: p.solve_mrhs(B, trans=True),
        lambda p, B: p.solve_mrhs(B, r=r),
        lambda p, B: p.solve_mrhs(B, trans=True, r=r),
        lambda p, B: p.solve(B[:, 0]),
        lambda p, B: p.solve(B[:, 0], trans=True, r=r),
        lambda p, B: p.mmultiply(B[:, 0]),
        lambda p, B: p.mmultiply(B[:, 0], trans=True),
        lambda p, B: ht.ir_apply(At, p, B, 3),
        lambda p, B: ht.ir_apply(At, p, B[:, 1], 2, r=r),
    ]
    for call in calls:
        for _ in range(3):
            B = torch.as_tensor(rng.standard_normal((A.nrows, 3)))
            assert torch.equal(call(dp, B), call(ref, B))
    assert dp.graph_cache.backend.captures == len(calls)
    assert dp.graph_cache.backend.replays == 2 * len(calls)
    assert ref.graph_cache is None


def test_keys(cd12, stand_in):
    """One program for each (callable, operands, shape, dtype, trans, r,
    nirs); the same call again replays."""
    A, M, precs = cd12
    dp = DevicePrec.from_host(precs, dense_inv=20, device=CPU)
    dp.pack_transpose(precs)
    At = sliced_ell_from_csr(_port(A), device=CPU)
    B = torch.ones((A.nrows, 2), dtype=torch.float64)
    for _ in range(2):
        dp.solve_mrhs(B)
        dp.solve_mrhs(B[:, :1])
        dp.solve_mrhs(B.float())
        dp.solve_mrhs(B, trans=True)
        dp.solve_mrhs(B, r=3)
        dp.solve_mrhs(B, r=4)
        ht.ir_apply(At, dp, B, 2)
        ht.ir_apply(At, dp, B, 3)
    cache = dp.graph_cache
    # B.float() is cast to the pack's dtype: the first loop replays it
    assert len(cache.entries) == 7
    assert cache.backend.captures == 7 and cache.backend.replays == 9
    shapes = {k[3] for k in cache.entries if k[0] is prec_solve_mrhs}
    assert {s[1] for s in shapes} == {(A.nrows, 2), (A.nrows, 1)}
    assert {s[2] for s in shapes} == {torch.float64}   # as_values casts
    rs = {k[4][2] for k in cache.entries if k[0] is prec_solve_mrhs}
    assert rs == {0, 3, 4}
    nirs = {k[5][2] for k in cache.entries if k[0] is ir_apply_mrhs}
    assert nirs == {2, 3}


def test_results_are_fresh_tensors(cd12, stand_in):
    A, M, precs = cd12
    dp = DevicePrec.from_host(precs, device=CPU)
    B1 = torch.ones((A.nrows, 2), dtype=torch.float64)
    X1 = dp.solve_mrhs(B1)
    X2 = dp.solve_mrhs(2 * B1)          # a replay
    keep = X2.clone()
    X3 = dp.solve_mrhs(3 * B1)          # overwrites the static output
    (ent,) = dp.graph_cache.entries.values()
    static = ent.out
    assert static.data_ptr() not in {X.data_ptr() for X in (X1, X2, X3)}
    assert torch.equal(X2, keep)
    assert torch.equal(static, X3)
    torch.testing.assert_close(X3, 3 * X1, rtol=1e-13, atol=0)


def _counts():
    return (spmv.sliced_ell_sub_mrhs_plain.calls, trsv.trsv_apply_plain.calls,
            bsr_spmv.bsr_matvec_mrhs_plain.calls)


@pytest.mark.parametrize("op", ["bsr", "sliced_ell"])
def test_counters_add_the_captured_counts_at_each_replay(cd12, stand_in, op):
    """n calls count n times one eager call's launches: the first call's
    warm-up counts itself, the capture counts nothing, each replay adds
    what the capture recorded."""
    A, M, precs = cd12
    dp = DevicePrec.from_host(precs, dense_inv=0, device=CPU)
    ref = DevicePrec.from_host(precs, dense_inv=0, device=CPU, graphs=False)
    Ao = _ops(A, op)[0]
    B = torch.ones((A.nrows, 2), dtype=torch.float64)
    c0 = _counts()
    ht.ir_apply(Ao, ref, B, 3)
    once = tuple(b - a for a, b in zip(c0, _counts()))
    assert once[0] > 0 and once[1] > 0 and (once[2] > 0) == (op == "bsr")
    for n in (1, 2, 5):
        c0 = _counts()
        for _ in range(n):
            ht.ir_apply(Ao, dp, B, 3)
        assert tuple(b - a for a, b in zip(c0, _counts())) == tuple(
            n * k for k in once)
    (ent,) = dp.graph_cache.entries.values()
    assert ent.delta[4:7] == once


def test_pack_methods_drop_the_graphs_they_replace(cd12, stand_in):
    A, M, precs = cd12
    dp = DevicePrec.from_host(precs, device=CPU)
    dp.pack_prod_tran(precs)
    dp.pack_prod(precs)
    B = torch.ones((A.nrows, 1), dtype=torch.float64)
    b = B[:, 0]

    def run():
        dp.solve_mrhs(B)
        dp.solve_mrhs(B, trans=True)
        dp.mmultiply(b)
        dp.mmultiply(b, trans=True)

    def programs():
        return sorted(k[0].__name__ for k in dp.graph_cache.entries)

    run()
    assert programs() == ["prec_prod_mrhs", "prec_prod_tran_mrhs",
                          "prec_solve_mrhs", "prec_solve_tran_mrhs"]
    x = dp.mmultiply(b)
    dp.pack_prod(precs)
    assert programs() == ["prec_prod_tran_mrhs", "prec_solve_mrhs",
                          "prec_solve_tran_mrhs"]
    assert torch.equal(dp.mmultiply(b), x)
    dp.pack_transpose(precs)        # the adjoint solve and product go
    assert programs() == ["prec_prod_mrhs", "prec_solve_mrhs"]
    dp.pack_prod_tran(precs)
    run()
    assert len(programs()) == 4
    # a stale graph would hold the old operand list
    for k in dp.graph_cache.entries:
        if k[0] is prec_prod_mrhs:
            assert k[2][1] == id(dp.prod)


def test_graphs_off_and_cpu_run_eagerly(cd12):
    """Without a backend for the CPU the cache is never made; with
    ``graphs=False`` it is not made either, whatever the device."""
    A, M, precs = cd12
    dp = DevicePrec.from_host(precs, device=CPU)
    dp.solve_mrhs(np.ones((A.nrows, 1)))
    assert graphs.cache_of(dp) is None and dp.graph_cache is None
    assert graphs.BACKENDS == {"cuda": graphs.CudaGraphs}


def test_jit_is_the_cache_call(cd12, stand_in):
    A, M, precs = cd12
    dp = DevicePrec.from_host(precs, device=CPU)
    dp.pack_prod(precs)
    X = torch.ones((A.nrows, 4), dtype=torch.float64)
    f = graphs.jit(dp, prec_prod_mrhs)
    assert f.__name__ == "prec_prod_mrhs"
    Y = [f(dp.levels, dp.prod, dp.tail, X) for _ in range(3)]
    assert all(torch.equal(y, Y[0]) for y in Y)
    assert torch.equal(Y[0], prec_prod_mrhs(dp.levels, dp.prod, dp.tail, X))
    assert dp.graph_cache.backend.replays == 2


def test_failed_capture_raises_and_never_runs_eagerly(cd12, monkeypatch):
    monkeypatch.setitem(graphs.BACKENDS, "cpu", FailingGraphs)
    A, M, precs = cd12
    dp = DevicePrec.from_host(precs, device=CPU)
    At = sliced_ell_from_csr(_port(A), device=CPU)
    B = torch.ones((A.nrows, 2), dtype=torch.float64)
    for _ in range(2):
        with pytest.raises(graphs.GraphCaptureError,
                           match="capture of prec_solve_mrhs failed"):
            dp.solve_mrhs(B)
    with pytest.raises(graphs.GraphCaptureError, match="_segment"):
        ht.gmres_hif(At, dp, B[:, 0])
    with pytest.raises(graphs.GraphCaptureError, match="_cycle_mrhs"):
        ht.gmres_mrhs(At, dp, B)
    assert not dp.graph_cache.entries


def test_distributed_objects_are_refused(cd12, tmp_path, stand_in):
    """DistPrec, the sharded IR step, the mesh's programs and the
    partitioned preconditioners are no longer refused: the distributed jit
    sites are captured programs (``tests/test_torch_dist_graphs.py`` holds
    them to the JAX package), and each replays equal to its eager run.  The
    refusal that stays: a GMRES driver given a DistPrec (its cycle programs
    run a DevicePrec's levels and tail)."""
    A, M, precs = cd12
    save_prec(str(tmp_path / "m.npz"), M)
    hm = ht.load_prec(str(tmp_path / "m.npz"))
    mesh = make_mesh(4, device=CPU)
    dist = DistPrec.from_host(mesh, hm, chunk=16)
    eager = DistPrec.from_host(mesh, hm, chunk=16, graphs=False)
    part = PartitionedHIF()
    step = make_sharded_ir_step(mesh, A.nrows)
    dp = DevicePrec.from_host(precs, device=CPU, graphs=False)
    for obj in (dist, part, DevicePartitionedPrec(part), step, mesh):
        assert not hasattr(obj, "graph_refusal")
    assert graphs.cache_of(part) is None      # composed on the host
    b = np.random.default_rng(12).standard_normal(A.nrows)
    for _ in range(2):
        assert torch.equal(dist.solve(b), eager.solve(b))
    assert dist.graph_cache.backend.replays == 1
    Ae = shard_ell_rows(mesh, _port(A))
    B = torch.zeros((Ae.nrows, 2), dtype=torch.float64)
    B[:A.nrows] = torch.as_tensor(np.stack([b, -b], 1))
    X = Xe = torch.zeros_like(B)
    for _ in range(2):
        X = step(Ae, dp.levels, dp.tail, X, B)
        mesh.graphs = False
        Xe = step(Ae, dp.levels, dp.tail, Xe, B)
        mesh.graphs = True
        assert torch.equal(X, Xe)
    assert mesh.graph_cache.backend.replays == 1
    At = sliced_ell_from_csr(_port(A), device=CPU)
    with pytest.raises(graphs.GraphRefused, match="DevicePrec"):
        ht.gmres_hif(At, dist, np.ones(A.nrows))
    with pytest.raises(graphs.GraphRefused, match="DevicePrec"):
        ht.gmres_mrhs(At, dist, np.ones((A.nrows, 2)))
    x = dist.solve(np.ones(A.nrows)).numpy()
    ref = dp.solve(np.ones(A.nrows)).numpy()
    assert np.abs(x - ref).max() <= 1e-10 * np.abs(ref).max()
