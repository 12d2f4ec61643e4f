"""The peer sweep: a distributed triangular factor's whole chunk loop when the
``rows`` ranks lie in several groups, on the split ``"cpu"`` / ``"cpu:0"``
mesh (two groups of four ranks, distinct devices to the mesh that share the
host's memory, as several cards with peer access share theirs).

Here: the plain peer sweep (``chunk_sweep_peer_plain``, the CPU path)
equals the per-chunk loops it replaces (``halo_chunk_loop``,
``ag_chunk_loop``) bit for bit, f32 and f64, chunk 64 and 256, L and U; the
peer plan's packed operands and send coordinates equal the JAX halo plan's
arrays; ``DistPrec`` in the ``"peer"`` form equals the JAX ``DistPrec`` on
the eight virtual CPU devices of ``tests/conftest.py`` (poisson2d(64),
chunk 64, halo and all_gather forms, 1e-12 f64 and 1e-5 f32 of max|x|);
the plan's form follows the mesh's peer access; the wrapper refuses CPU
operands; and ``dryrun_multichip`` with one rank a listed device.  The
kernel itself runs on the card only (``tests/test_torch_dist_card.py``).
"""

import numpy as np
import pytest
import torch

from hifir_tpu.models import poisson2d, random_strict_triangular
from hifir_tpu.parallel import DistPrec as JDistPrec
from hifir_tpu.parallel import make_mesh as jmake_mesh
import hifir_tpu.parallel as jpar

import hifir_tpu_torch as ht
from hifir_tpu_torch import parallel as tpar
from hifir_tpu_torch.alg.prec import prec_solve_mrhs
from hifir_tpu_torch.entry import dryrun_multichip
from hifir_tpu_torch.ops import chunk as tchunk
from hifir_tpu_torch.parallel import DistPrec, Mesh, make_mesh
from hifir_tpu_torch.parallel import mesh as tmesh_mod
from hifir_tpu_torch.parallel import trsv_sharded
from hifir_tpu_torch.parallel.trsv_halo import HaloOp, halo_chunk_loop

from test_torch_chunk_sweep import N_LEGS, SEED_LEGS, _x0
from test_torch_native import jax_lib, jax_lib_path  # noqa: F401
from test_torch_parallel import SPLIT, _assert_halo_plans_equal, _np
from test_torch_parallel_prec import RED, pair  # noqa: F401
from test_torch_prec import _port

DTYPES = {"float32": torch.float32, "float64": torch.float64}


@pytest.fixture(scope="module")
def split():
    return Mesh(SPLIT)


def _halo_entry(op, b, dt):
    """Every rank's working vector at the solve's entry (own slots from b,
    the halo zero), (D, buf_len)."""
    x = torch.zeros((op.D, op.buf_len), dtype=dt)
    bt = torch.as_tensor(np.append(b, 0.0), dtype=dt)
    x[:, :op.own_len] = bt[torch.cat(op.in_rows)]
    return x


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("chunk", [64, 256])
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_peer_plain_equals_halo_chunk_loop(split, dname, chunk, lower):
    """The halo form with all three legs, some of them across the groups:
    the plain peer sweep leaves the slot vectors ``halo_chunk_loop`` (K10a
    a chunk, the mesh's shift and all_gather) leaves, bit for bit."""
    dt = DTYPES[dname]
    T = random_strict_triangular(N_LEGS, lower=lower, seed=SEED_LEGS)
    op = tpar.build_halo_op(split, _port(T), lower=lower, chunk=chunk,
                            dtype=np.dtype(dname))
    assert op.plan.form == "peer" and op.plan.sweeps == op.packed
    assert op.plan.lo == (0, 4, 8)
    meta = np.asarray(op.meta)
    assert (meta[:, 1] > 0).any() and (meta[:, 3] > 0).any() \
        and (meta[:, 5] > 0).any(), "a leg kind is missing"
    b = np.random.default_rng(chunk).standard_normal(op.n)
    x0 = _halo_entry(op, b, dt)
    xa = [x0[:4].clone(), x0[4:].clone()]
    xb = [x0[:4].clone(), x0[4:].clone()]
    halo_chunk_loop(op, xa)
    tchunk.chunk_sweep_peer_plain.calls = 0
    tchunk.chunk_sweep_peer(xb, op.plan)
    assert tchunk.chunk_sweep_peer_plain.calls == 1
    for a, c in zip(xa, xb):
        assert torch.equal(a, c)
    assert not torch.equal(torch.cat(xb), x0)
    # the boundary ranks 3 and 4 exchanged their neighbour legs
    for off_l, Wl, off_r, Wr, _, _ in op.meta:
        assert not xb[0][0, off_l:off_l + Wl].any()
        assert not xb[1][-1, off_r:off_r + Wr].any()
    xr = T.solve_as_strict_lower(b) if lower else T.solve_as_strict_upper(b)
    np.testing.assert_allclose(
        _np(tpar.halo_trsv_apply(op, b)), xr, rtol=0,
        atol=(1e-4 if dt == torch.float32 else 1e-10) * np.abs(xr).max())


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("chunk", [64, 256])
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_peer_plain_equals_ag_chunk_loop(split, dname, chunk, lower):
    """The all_gather form: the plain peer sweep (every rank's slots into
    every rank's copy, across the groups) equals ``ag_chunk_loop`` bit for
    bit, and ``sharded_trsv_apply`` through it solves the factor."""
    dt = DTYPES[dname]
    T = random_strict_triangular(600, lower=lower, seed=4)
    st = tpar.shard_trsv_schedule(split, _port(T), lower=lower, chunk=chunk)
    vals = [tchunk.with_slack(v, dt) for v in st.vals]
    st = trsv_sharded.ShardedTrsv(split, st.in_rows, st.cols, vals,
                                  st.out_slots, st.n, st.nchunks, st.chunk,
                                  st.nslots)
    assert st.plan.form == "peer" and st.nchunks > 5
    assert [sw.ranks for sw in st.plan.sweeps] == [4, 4]
    x0 = _x0(np.random.default_rng(chunk), 8, st.nslots + 1, dt)
    xa = [x0[:4].clone(), x0[4:].clone()]
    xb = [x0[:4].clone(), x0[4:].clone()]
    trsv_sharded.ag_chunk_loop(split, xa, st.cols, st.vals, st.chunk,
                               st.nchunks)
    tchunk.chunk_sweep_peer_plain(xb, st.plan)
    for a, c in zip(xa, xb):
        assert torch.equal(a, c)
    assert not torch.equal(torch.cat(xb), x0)
    b = np.random.default_rng(3).standard_normal(st.n)
    xr = T.solve_as_strict_lower(b) if lower else T.solve_as_strict_upper(b)
    np.testing.assert_allclose(
        _np(tpar.sharded_trsv_apply(st, b)), xr, rtol=0,
        atol=(1e-4 if dt == torch.float32 else 1e-10) * np.abs(xr).max())


def test_peer_plan_matches_jax_halo_plan(split):
    """The peer plan's sweeps are each group's packed operands: every
    chunk's dependency block, values and send coordinates, read back from
    the flat buffers through the records, equal the JAX halo plan's arrays
    at the group's ranks, and every group's records carry the same
    ``meta``."""
    T = random_strict_triangular(N_LEGS, lower=True, seed=SEED_LEGS)
    jop = jpar.build_halo_op(jmake_mesh(8, rhs=1), T, lower=True, chunk=64)
    op = tpar.build_halo_op(split, _port(T), lower=True, chunk=64)
    _assert_halo_plans_equal(op, jop, split)
    plan = op.plan
    assert plan.form == "peer"
    for g, sw in enumerate(plan.sweeps):
        lo, hi = plan.lo[g], plan.lo[g + 1]
        assert sw.ranks == hi - lo
        np.testing.assert_array_equal(sw.desc_host[:, 3:9],
                                      np.asarray(jop.meta))
        for c in range(op.nchunks):
            cols, vals, sends = sw.halo_chunk(c)
            np.testing.assert_array_equal(_np(cols),
                                          np.asarray(jop.gcols[c])[lo:hi])
            np.testing.assert_array_equal(_np(vals),
                                          np.asarray(jop.gvals[c])[lo:hi])
            legs = [np.asarray(s)[lo:hi] for s in jop.sends[c]]
            want = (np.concatenate(legs, axis=1) if legs
                    else np.zeros((hi - lo, 0), np.int64))
            np.testing.assert_array_equal(_np(sends), want)


@pytest.mark.parametrize("halo", [True, False])
def test_distprec_peer_matches_jax(pair, split, halo):  # noqa: F811
    """``DistPrec`` on the split mesh, every factor in the ``"peer"`` form
    (one plain peer-sweep call a factor application, no K10a step), equals
    the JAX ``DistPrec`` on its eight virtual devices: within 1e-12 of
    max|x| in f64 and 1e-5 in f32."""
    A, J, P = pair
    jmesh = jmake_mesh(8, rhs=1)
    b = np.random.default_rng(11).standard_normal(A.nrows)
    for npdt, tol in ((np.float64, 1e-12), (np.float32, 1e-5)):
        dp = DistPrec.from_host(split, P, chunk=64, halo=halo, dtype=npdt)
        ops = [op for lv in dp.levels for op in (lv.L_op, lv.U_op)
               if op.nchunks]
        assert {op.plan.form for op in ops} == {"peer"}
        assert sum(isinstance(op, HaloOp) for op in ops) == (
            dp.n_halo if halo else 0)
        tchunk.chunk_sweep_peer_plain.calls = 0
        tchunk.chunk_fma_plain.calls = 0
        x = _np(dp.solve(b)).astype(np.float64)
        assert tchunk.chunk_sweep_peer_plain.calls == 2 * len(ops)
        assert tchunk.chunk_fma_plain.calls == 0
        jx = np.asarray(JDistPrec.from_host(jmesh, J, chunk=64, halo=halo,
                                            dtype=npdt).solve(b),
                        dtype=np.float64)
        np.testing.assert_allclose(x, jx, rtol=0, atol=tol * np.abs(jx).max())


def test_form_follows_peer_access(split, monkeypatch):
    """The plan's form is read from the mesh's topology: ``"peer"`` while
    the groups reach each other's memory, ``"chunk"`` once the mesh's query
    says they do not (or when asked for), ``"sweep"`` on one group; on
    CUDA devices the query is ``torch.cuda.can_device_access_peer``, and
    two groups of one card (``"cuda:0"`` and ``"cuda"``) need none."""
    T = _port(random_strict_triangular(300, lower=True, seed=2))
    one = make_mesh(8, device="cpu")

    def forms(mesh, **kw):
        return (tpar.build_halo_op(mesh, T, lower=True, chunk=64,
                                   **kw).plan.form,
                tpar.shard_trsv_schedule(mesh, T, lower=True, chunk=64,
                                         **kw).plan.form)

    assert split.peer_access().all()
    assert forms(split) == ("peer", "peer")
    assert forms(split, form="chunk") == ("chunk", "chunk")
    assert forms(one) == ("sweep", "sweep")
    with pytest.raises(ValueError, match="form"):
        forms(split, form="peer")
    monkeypatch.setattr(tmesh_mod, "can_device_access_peer",
                        lambda a, b: False)
    assert not split.peer_access()[0, 1]
    assert forms(split) == ("chunk", "chunk")
    monkeypatch.undo()

    asked = []

    def can(a, b):
        asked.append((a, b))
        return False

    monkeypatch.setattr(torch.cuda, "can_device_access_peer", can)
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert not tmesh_mod.can_device_access_peer(c0, c1)
    assert asked == [(0, 1)]
    assert tmesh_mod.can_device_access_peer(c0, torch.device("cuda", 0))
    assert not tmesh_mod.can_device_access_peer(c0, torch.device("cpu"))
    assert tmesh_mod.device_index(torch.device("cpu")) is None
    assert tmesh_mod.device_index(c1) == 1
    assert [tmesh_mod.device_index(g.device)
            for g in Mesh([c0] * 2 + [c1] * 2).groups()] == [0, 1]


def test_peer_kernel_entry_checks(split):
    """The card's entry refuses CPU operands (the CPU runs the plain
    version only because its tensors lie there), and the plain version
    refuses slot vectors of the wrong shape or number."""
    T = _port(random_strict_triangular(300, lower=True, seed=2))
    op = tpar.build_halo_op(split, T, lower=True, chunk=64)
    with pytest.raises(ValueError, match="CUDA"):
        tchunk.PeerSweepKernel(op.plan)
    x = torch.zeros((4, op.buf_len), dtype=torch.float64)
    with pytest.raises(ValueError, match="expected"):
        tchunk.chunk_sweep_peer_plain([x, x[:, :-1]], op.plan)
    with pytest.raises(ValueError):
        tchunk.chunk_sweep_peer_plain([x], op.plan)
    assert tchunk.chunk_sweep_peer([x, x.clone()], op.plan)[0] is x


def test_dryrun_multichip_one_rank_a_device():
    """``dryrun_multichip`` with ``devices``: one rank on each listed device
    (two groups of four on the CPU), its asserts pass, and its DistPrec's
    factors run the peer form; a device list of another length is
    refused."""
    devs = ["cpu"] * 4 + ["cpu:0"] * 4
    tchunk.chunk_sweep_peer_plain.calls = 0
    r = dryrun_multichip(8, device="cpu", devices=devs)
    dp = r["dist"]
    assert [g.device for g in dp.mesh.groups()] == [torch.device(d) for d in
                                                    ("cpu", "cpu:0")]
    ops = [op for lv in dp.levels for op in (lv.L_op, lv.U_op)
           if op.nchunks]
    assert ops and {op.plan.form for op in ops} == {"peer"}
    assert tchunk.chunk_sweep_peer_plain.calls == 2 * len(ops)
    assert r["ir_residual2"] < r["ir_residual0"]
    with pytest.raises(ValueError, match="one rank"):
        dryrun_multichip(8, device="cpu", devices=devs[:4])


def test_pack_to_device_rebuilds_the_pack():
    """``parallel/sharded.py:to_device`` (the IR step's copy of the pack for
    another card) rebuilds every dataclass, list and tuple of a pack with
    blocked inverses, schedules and a dense tail, keeps host arrays and
    scalars, and the copy solves as the pack does."""
    from hifir_tpu_torch.parallel.sharded import to_device

    P = ht.HIF().factorize(_port(poisson2d(48)),
                           ht.Options(**dict(RED, dense_thres=30)),
                           device="cpu")
    dp = P.to_device(dtype=np.float64, dense_inv=16, device="cpu")
    levels, tail = to_device((dp.levels, dp.tail), torch.device("cpu"))
    assert levels is not dp.levels and type(levels) is type(dp.levels)
    for a, b in zip(levels, dp.levels):
        assert a is not b and type(a) is type(b) and a.m == b.m
        assert torch.equal(a.p, b.p)
    B = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (P.precs[0].n, 3)))
    assert torch.equal(prec_solve_mrhs(levels, tail, B),
                       prec_solve_mrhs(dp.levels, dp.tail, B))
