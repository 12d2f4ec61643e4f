"""The distributed jit sites as captured programs, on the CPU.

The JAX package jits ``DistPrec``'s whole solve, ``halo_trsv_apply``,
``sharded_trsv_apply``, ``halo_spmv``, the sharded IR step and the ring
Schur step and rotation; the port captures each as a CUDA graph in its
owner's cache (the ``DistPrec``'s, or the mesh's).  Here the CUDA backend
is swapped for ``test_torch_graphs.EagerGraphs`` (its capture runs the
program on copies, its replay runs it again on the static arguments with
the counters held), on a mesh of one group (``make_mesh(8, device="cpu")``)
and of two groups (``Mesh(["cpu"] * 4 + ["cpu:0"] * 4)``, the peer form).
Each replayed call equals the eager call bit for bit and the JAX function
on the eight virtual CPU devices of ``tests/conftest.py`` within 1e-12 of
max|x| (f64); a replay takes inputs other than the capture's; the
distribution's counters gain the captured counts at each replay; the peer
sweep's entry takes the same host arguments at every call (its epoch is a
device pointer); the partitioned preconditioner's parts replay.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import hifir_tpu.parallel as jpar
from hifir_tpu.api import HIF as JHIF
from hifir_tpu.models import (convdiff2d, poisson2d, random_sparse,
                              random_strict_triangular)
from hifir_tpu.options import Options as JOptions
from hifir_tpu.parallel import DistPrec as JDistPrec
from hifir_tpu.parallel import make_mesh as jmake_mesh
from hifir_tpu.parallel.schur import schur_spgemm_ring as jring
import hifir_tpu.pre._native as jnative

import hifir_tpu_torch as ht
from hifir_tpu_torch import graphs
from hifir_tpu_torch import parallel as tpar
from hifir_tpu_torch.ops import chunk as tchunk
from hifir_tpu_torch.parallel import (DistPrec, Mesh, PartitionedHIF,
                                      make_mesh)
from hifir_tpu_torch.parallel import mesh as tmesh
from hifir_tpu_torch.parallel import schur as tschur

from test_torch_graphs import EagerGraphs, FailingGraphs
from test_torch_native import jax_lib_path  # noqa: F401
from test_torch_parallel_prec import RED
from test_torch_parallel import SPLIT, _np
from test_torch_prec import _carry, _port

CPU = "cpu"
OPTS = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5, kappa_d=5,
            verbose=0, dense_thres=30)
LAYOUTS = {"one group": lambda: make_mesh(8, device=CPU),
           "two groups": lambda: Mesh(SPLIT)}


@pytest.fixture
def stand_in(monkeypatch):
    """Every CPU owner with ``graphs`` on runs through the cache."""
    monkeypatch.setitem(graphs.BACKENDS, "cpu", EagerGraphs)


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(8, rhs=1)


@pytest.fixture(scope="module")
def p64(jax_lib_path, tmp_path_factory):  # noqa: F811
    """poisson2d(64) factorized by the JAX package with its native library
    (three levels under the JAX distribution tests' options, so that the
    levels are linked by exchange plans), and the port's HIF from its
    levels: the same factors in both packages."""
    A = poisson2d(64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HIFIR_TPU_LIB", jax_lib_path)
        mp.setattr(jnative, "_LIB", None)
        mp.setattr(jnative, "_TRIED", False)
        M = JHIF().factorize(A, JOptions(**RED))
    hm = ht.HIF()
    hm.precs = _carry(M, tmp_path_factory.mktemp("p64"))
    assert hm.levels() >= 3
    return A, M, hm


@pytest.fixture(scope="module")
def jax_solves(p64, jmesh):
    """The JAX DistPrec's solves of the two right-hand sides, halo and
    all_gather forms (chunk 64)."""
    A, M, _ = p64
    bs = _rhs(A.nrows)
    out = {}
    for halo in (True, False):
        jdp = JDistPrec.from_host(jmesh, M, chunk=64, halo=halo)
        out[halo] = [np.asarray(jdp.solve(jnp.asarray(b))) for b in bs]
    return out


def _rhs(n):
    rng = np.random.default_rng(21)
    return [rng.standard_normal(n) for _ in range(2)]


def _close(x, ref):
    np.testing.assert_allclose(_np(x), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def _counts():
    """The distribution's counters on the CPU: its kernels' plain versions
    and K1's."""
    return (tchunk.chunk_fma_plain.calls, tchunk.chunk_sweep_plain.calls,
            tchunk.chunk_sweep_peer_plain.calls,
            tschur.schur_partial_plain.calls,
            ht.ops.spmv.sliced_ell_sub_mrhs_plain.calls)


def _delta(c0):
    return tuple(b - a for a, b in zip(c0, _counts()))


# ---------------------------------------------------------------------------
# DistPrec.solve


@pytest.mark.parametrize("form", [None, "chunk"], ids=["layout", "chunk"])
@pytest.mark.parametrize("halo", [True, False], ids=["halo", "all_gather"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_dist_solve_replayed_matches_eager_and_jax(p64, jax_solves,
                                                   stand_in, layout, halo,
                                                   form):
    """The first call (warm-up and capture), then replays fed other
    right-hand sides: each bit-equal to the eager DistPrec and within
    1e-12 of the JAX DistPrec; one program, one capture, the rest
    replays."""
    A, _, hm = p64
    mesh = LAYOUTS[layout]()
    dp = DistPrec.from_host(mesh, hm, chunk=64, halo=halo, form=form)
    ref = DistPrec.from_host(mesh, hm, chunk=64, halo=halo, form=form,
                             graphs=False)
    forms = {op.plan.form for lv in dp.levels for op in (lv.L_op, lv.U_op)
             if op.nchunks}
    want = form or ("sweep" if layout == "one group" else "peer")
    assert forms == {want}
    assert (dp.n_halo > 0) == halo
    bs = _rhs(A.nrows)
    for b, jx in zip(bs + bs[::-1], jax_solves[halo] + jax_solves[halo][::-1]):
        x = dp.solve(b)
        assert torch.equal(x, ref.solve(b))
        _close(x, jx)
    backend = dp.graph_cache.backend
    assert len(dp.graph_cache.entries) == 1
    assert (backend.captures, backend.replays) == (1, 3)
    assert ref.graph_cache is None


def test_dist_solve_result_is_fresh(p64, stand_in):
    """Rank 0's copy of x comes back as a fresh tensor: the next replay
    does not overwrite it."""
    A, _, hm = p64
    dp = DistPrec.from_host(Mesh(SPLIT), hm, chunk=64)
    b1, b2 = _rhs(A.nrows)
    dp.solve(b1)
    x = dp.solve(b1)
    keep = x.clone()
    dp.solve(b2)
    (ent,) = dp.graph_cache.entries.values()
    assert torch.equal(x, keep) and x.data_ptr() != ent.out.data_ptr()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_dist_counters_add_the_captured_counts(p64, stand_in, layout):
    """n solves count n times one eager solve's launches (plain calls on
    the CPU) in every form: the warm-up counts itself, the capture counts
    nothing, each replay adds what the capture recorded."""
    A, _, hm = p64
    mesh = LAYOUTS[layout]()
    b = _rhs(A.nrows)[0]
    for form in (None, "chunk"):
        ref = DistPrec.from_host(mesh, hm, chunk=64, form=form,
                                 graphs=False)
        dp = DistPrec.from_host(mesh, hm, chunk=64, form=form)
        c0 = _counts()
        ref.solve(b)
        once = _delta(c0)
        # the sweep, the peer sweep or K10a a chunk, and K1
        assert once[4] > 0 and sum(x > 0 for x in once[:3]) == 1
        for n in (1, 2, 3):
            c0 = _counts()
            for _ in range(n):
                dp.solve(b)
            assert _delta(c0) == tuple(n * k for k in once)


def test_interleaved_eager_and_replayed_solves_agree(p64, stand_in):
    """Eager and replayed solves of one peer-form DistPrec, interleaved
    four times each: every result equal bit for bit."""
    A, _, hm = p64
    dp = DistPrec.from_host(Mesh(SPLIT), hm, chunk=64)
    b = _rhs(A.nrows)[1]
    xs = []
    for _ in range(4):
        for on in (False, True):
            dp.graphs = on
            xs.append(dp.solve(b))
    assert all(torch.equal(x, xs[0]) for x in xs)
    assert dp.graph_cache.backend.replays == 3


def test_failed_dist_capture_raises(p64, monkeypatch):
    monkeypatch.setitem(graphs.BACKENDS, "cpu", FailingGraphs)
    A, _, hm = p64
    dp = DistPrec.from_host(Mesh(SPLIT), hm, chunk=64)
    for _ in range(2):
        with pytest.raises(graphs.GraphCaptureError, match="_solve"):
            dp.solve(np.ones(A.nrows))
    assert not dp.graph_cache.entries


# ---------------------------------------------------------------------------
# the mesh's programs against their JAX functions


@pytest.fixture(scope="module")
def jmesh_rows():
    return jmake_mesh(8, rhs=1)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_halo_and_sharded_trsv_replayed_match_jax(jmesh_rows, stand_in,
                                                 layout):
    """``halo_trsv_apply`` and ``sharded_trsv_apply`` as programs of the
    mesh's cache, fed two right-hand sides after the capture: within
    1e-12 of the JAX functions, bit-equal to the eager applies."""
    n = 300
    T = random_strict_triangular(n, lower=True, seed=4)
    mesh = LAYOUTS[layout]()
    op = tpar.build_halo_op(mesh, _port(T), lower=True, chunk=64)
    st = tpar.shard_trsv_schedule(mesh, _port(T), lower=True, chunk=64)
    jop = jpar.build_halo_op(jmesh_rows, T, lower=True, chunk=64)
    jst = jpar.shard_trsv_schedule(jmesh_rows, T, lower=True, chunk=64)
    rng = np.random.default_rng(3)
    bs = [rng.standard_normal(n) for _ in range(3)]
    for b in bs:
        x = tpar.halo_trsv_apply(op, b)
        y = tpar.sharded_trsv_apply(st, b)
        _close(x, np.asarray(jpar.halo_trsv_apply(jop, b)))
        _close(y, np.asarray(jpar.sharded_trsv_apply(jst, b)))
        mesh.graphs = False
        assert torch.equal(x, tpar.halo_trsv_apply(op, b))
        assert torch.equal(y, tpar.sharded_trsv_apply(st, b))
        mesh.graphs = True
    backend = mesh.graph_cache.backend
    assert len(mesh.graph_cache.entries) == 2
    assert (backend.captures, backend.replays) == (2, 4)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_halo_spmv_replayed_matches_jax(jmesh_rows, stand_in, layout):
    A = poisson2d(16)
    mesh = LAYOUTS[layout]()
    H = tpar.build_halo_spmv(mesh, _port(A))
    JH = jpar.build_halo_spmv(jmesh_rows, A)
    rng = np.random.default_rng(5)
    for _ in range(3):
        x = rng.standard_normal(H.nb * 8)
        x[A.nrows:] = 0.0
        xs = jax.device_put(jnp.asarray(x),
                            NamedSharding(jmesh_rows, JP("rows")))
        y = tpar.halo_spmv(H, torch.tensor(x))
        _close(y, np.asarray(jpar.halo_spmv(JH, xs)))
        mesh.graphs = False
        assert torch.equal(y, tpar.halo_spmv(H, torch.tensor(x)))
        mesh.graphs = True
    assert mesh.graph_cache.backend.replays == 2


def test_ir_step_replayed_matches_jax(p64, stand_in, tmp_path):
    """Ten IR steps on a (2, 4) mesh of two groups: each step a replay
    after the first, X within 1e-12 of the JAX step's and bit-equal to
    the eager step's; the residual falls."""
    A, M, hm = p64
    n = A.nrows
    jm = jmake_mesh(8, rhs=2)
    JAe = jpar.shard_ell_rows(jm, A)
    jlev, jtail = M.to_device().operands()
    jstep = jpar.make_sharded_ir_step(jm, n)
    dp = hm.to_device(device=CPU)
    tm = Mesh(SPLIT, rhs=2)
    Ae = tpar.shard_ell_rows(tm, _port(A))
    step = tpar.make_sharded_ir_step(tm, n)
    eager = tpar.make_sharded_ir_step(tm, n)
    npad = Ae.nrows
    B = np.random.default_rng(1).standard_normal((n, 4))
    Bp = np.concatenate([B, np.zeros((npad - n, 4))])
    JX = jnp.zeros((npad, 4))
    X = torch.zeros((npad, 4), dtype=torch.float64)
    Bt = torch.tensor(Bp)
    res = []
    for _ in range(10):
        JX = jstep(JAe.indices, JAe.values, jlev, jtail, JX, jnp.asarray(Bp))
        tm.graphs = False
        Xe = eager(Ae, dp.levels, dp.tail, X, Bt)
        tm.graphs = True
        X = step(Ae, dp.levels, dp.tail, X, Bt)
        assert torch.equal(X, Xe)
        _close(X, np.asarray(JX))
        Xn = X.numpy()[:n]
        res.append(max(np.linalg.norm(B[:, k] - A.matvec(Xn[:, k]))
                       for k in range(4)))
    assert all(b < a for a, b in zip(res, res[1:]))
    assert tm.graph_cache.backend.replays == 9


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_schur_ring_replayed_matches_jax(jmesh_rows, stand_in, layout):
    """The ring's step and rotation, two programs of the mesh's cache: D
    steps (one capture, D - 1 replays) and D - 1 rotations; the product
    equals the JAX ring's (pattern exactly, values 1e-12) and the eager
    ring's bit for bit."""
    rng = np.random.default_rng(7)
    m, nm = 90, 53
    L_E = random_sparse(nm, 6, seed=1, ncols=m)
    U_F = random_sparse(m, 5, seed=2, ncols=nm)
    C = random_sparse(nm, 4, seed=3, ncols=nm)
    d = rng.standard_normal(m) + 2.0
    mesh = LAYOUTS[layout]()
    S = tschur.schur_spgemm_ring(_port(C), _port(L_E), d, _port(U_F),
                                 mesh=mesh)
    JS = jring(C, L_E, d, U_F, mesh=jmesh_rows)
    np.testing.assert_array_equal(S.indptr, JS.indptr)
    np.testing.assert_array_equal(S.indices, JS.indices)
    np.testing.assert_allclose(S.data, JS.data, rtol=1e-12, atol=1e-13)
    names = sorted(k[0].__name__ for k in mesh.graph_cache.entries)
    assert names == ["_ring_rotate", "_ring_step"]
    assert (mesh.graph_cache.backend.captures,
            mesh.graph_cache.backend.replays) == (2, 8 - 1 + 7 - 1)
    mesh.graphs = False
    E = tschur.schur_spgemm_ring(_port(C), _port(L_E), d, _port(U_F),
                                 mesh=mesh)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(S, f), getattr(E, f))


def test_dist_schur_factorize_with_graphs(stand_in):
    """``dist_schur=1`` with the ring's programs replayed: the levels and
    the tail equal the host Schur's (the factorize makes its own mesh a
    ring, on the CPU here)."""
    A = convdiff2d(40)
    base = dict(OPTS, dense_thres=20, use_native=0)
    Ph = ht.HIF().factorize(_port(A), ht.Options(**base), device=CPU)
    c0 = tschur.schur_partial_plain.calls
    Pd = ht.HIF().factorize(_port(A), ht.Options(dist_schur=1, **base),
                            device=CPU)
    assert tschur.schur_partial_plain.calls > c0
    assert [(p.m, p.n) for p in Pd.precs] == [(p.m, p.n) for p in Ph.precs]
    if Ph.precs[-1].dense_matrix is not None:
        np.testing.assert_allclose(Pd.precs[-1].dense_matrix,
                                   Ph.precs[-1].dense_matrix, rtol=1e-12,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# the peer sweep's host arguments


def test_peer_kernel_passes_the_same_host_arguments(monkeypatch):
    """``PeerSweepKernel`` keeps no host epoch: every call passes the same
    arguments, the epoch as the pointer of the card's counter in device
    memory (the kernel bumps it), so that a captured launch replays as an
    eager call runs."""
    T = _port(random_strict_triangular(300, lower=True, seed=2))
    split = Mesh(SPLIT)
    op = tpar.build_halo_op(split, T, lower=True, chunk=64)
    seen = []

    class Lib:
        @staticmethod
        def fn(name, sfx):
            assert name == "chunk_peer"
            return lambda *a: seen.append(a) or 0

    class Stream:
        cuda_stream = 77

    monkeypatch.setattr(tchunk, "load_kernels", lambda: Lib)
    monkeypatch.setattr(tchunk, "_card_operands", lambda sw: (0, 5, 7))
    monkeypatch.setattr(tchunk, "_fit_ring", lambda sw, k, w: (3, 1024))
    monkeypatch.setattr(tchunk, "_check_card_x", lambda x, sw: None)
    monkeypatch.setattr(tmesh, "device_index", lambda dev: 0)
    monkeypatch.setattr(tchunk, "check", lambda err, what: None)
    monkeypatch.setattr(torch.cuda, "device", lambda card: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda card: Stream)
    k = tchunk.PeerSweepKernel(op.plan)
    assert not hasattr(k, "epoch") and list(k.epochs) == [0]
    xs = [torch.zeros((4, op.buf_len), dtype=torch.float64)
          for _ in range(2)]
    tchunk.PeerSweepKernel.launches = 0
    for _ in range(3):
        k(xs)
    assert tchunk.PeerSweepKernel.launches == 3 and len(seen) == 3
    assert seen[0] == seen[1] == seen[2]
    # the epoch argument: the card's counter, in device memory, still 0
    assert seen[0][-2] == k.epochs[0].data_ptr()
    assert int(k.epochs[0]) == 0


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


# ---------------------------------------------------------------------------
# the backend a mesh gets, and the partitioned parts


def test_backend_follows_the_cards(monkeypatch):
    """One card (also "cuda:0" with "cuda") is one graph of CudaGraphs;
    several cards are MultiCardGraphs over them; the CPU has none unless a
    stand-in is set; a mix of types runs eagerly."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    c = lambda s: torch.device(s)  # noqa: E731
    one = graphs._backend((c("cuda:0"),) * 4 + (c("cuda"),) * 4)
    assert one.func is graphs.CudaGraphs and one.args == (c("cuda:0"),)
    many = graphs._backend((c("cuda:0"), c("cuda:2"), c("cuda:1")))
    assert many.func is graphs.MultiCardGraphs and many.args == ([0, 2, 1],)
    assert graphs._backend((c("cpu"), c("cpu:0"))) is None
    assert graphs._backend((c("cpu"), c("cuda:0"))) is None
    monkeypatch.setitem(graphs.BACKENDS, "cpu", EagerGraphs)
    assert graphs._backend((c("cpu"), c("cpu:0"))).func is EagerGraphs


def test_partitioned_parts_replayed(stand_in):
    """``DevicePartitionedPrec``'s parts are packs with graphs on: the
    second apply replays every part, equal to the eager parts and the
    host RAS; with a DistPrec a part, each part's DistPrec replays."""
    A = poisson2d(24)
    PP = PartitionedHIF().factorize(_port(A), 3, ht.Options(**OPTS))
    b = np.random.default_rng(2).standard_normal(A.nrows)
    xr = PP.solve(b)
    dpp = PP.to_device(device=CPU)
    x1, x2 = dpp.solve(b), dpp.solve(b)
    assert all(dp.graphs and dp.graph_cache.backend.replays == 1
               for dp in dpp.device_precs)
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_allclose(x2, xr, rtol=0, atol=1e-12 * np.abs(xr).max())
    PP.attach_dist_solvers(Mesh(SPLIT), chunk=64, device=CPU)
    xa = [PP.local_contrib(b) for _ in range(2)]
    np.testing.assert_array_equal(xa[0], xa[1])
    np.testing.assert_allclose(xa[1], xr, rtol=0,
                               atol=1e-12 * np.abs(xr).max())
    assert all(p.M_dist.graph_cache.backend.replays == 1 for p in PP.parts)


def test_dryrun_multichip_replays(stand_in):
    """``dryrun_multichip`` through the graphs: its asserts hold, its
    second IR step replays the first's program, its DistPrec's solve was
    captured and a later solve replays it, equal bit for bit."""
    from hifir_tpu_torch.entry import dryrun_multichip

    r = dryrun_multichip(8, device=CPU,
                         devices=["cpu"] * 4 + ["cpu:0"] * 4)
    assert r["ir_residual2"] < r["ir_residual0"]
    dp = r["dist"]
    assert dp.graph_cache.backend.captures == 1
    x = dp.solve(np.ones(dp.levels[0].n)).numpy()
    assert dp.graph_cache.backend.replays == 1
    np.testing.assert_array_equal(x, r["x"])
