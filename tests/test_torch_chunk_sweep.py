"""The chunk sweep (K10a redesigned: a factor's whole chunk loop in one call)
against the per-chunk loop it replaces, on the port's CPU meshes.

On a mesh whose eight ranks share one device the distributed trsv runs
``chunk_sweep`` (on the CPU its plain version); on the split ``"cpu"`` /
``"cpu:0"`` mesh it runs the peer sweep by default
(``test_torch_peer_sweep.py``) and K10a a chunk with the mesh's copies when
``form="chunk"`` asks for it.  Here: the plain sweep equals the per-chunk
loop bit for bit (all_gather form, halo form with all three legs,
``sharded_trsv_apply``; f32 and f64; chunk 64 and 256), the halo operands'
packed views equal the JAX plan's, and the dispatch counts of both forms
on two groups.  The comparisons of the solves with the JAX package on both
layouts are in ``test_torch_parallel.py`` and
``test_torch_parallel_prec.py``.
"""

import numpy as np
import pytest
import torch

from hifir_tpu.models import poisson2d, random_strict_triangular
from hifir_tpu.parallel import make_mesh as jmake_mesh
import hifir_tpu.parallel as jpar

import hifir_tpu_torch as ht
from hifir_tpu_torch import parallel as tpar
from hifir_tpu_torch.ops import chunk as tchunk
from hifir_tpu_torch.parallel import DistPrec, Mesh, make_mesh
from hifir_tpu_torch.parallel import trsv_sharded
from hifir_tpu_torch.parallel.trsv_halo import HaloOp, halo_chunk_loop

from test_torch_parallel_prec import RED
from test_torch_parallel import SPLIT, _assert_halo_plans_equal, _np
from test_torch_prec import _port

DTYPES = {"float32": torch.float32, "float64": torch.float64}
# a factor whose halo plan carries all three legs at chunk 64 and 256
N_LEGS, SEED_LEGS = 1200, 9


@pytest.fixture(scope="module")
def one():
    return make_mesh(8, device="cpu")


def _x0(rng, R, L, dt):
    x = torch.as_tensor(rng.standard_normal((R, L)), dtype=dt)
    x[:, -1] = 0
    return x


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("chunk", [64, 256])
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_ag_sweep_plain_equals_chunk_loop(one, dname, chunk, lower):
    """The all_gather form: the plain sweep and the per-chunk K10a loop with
    the mesh's all_gather leave the same slot vectors, bit for bit."""
    dt = DTYPES[dname]
    T = random_strict_triangular(600, lower=lower, seed=4)
    st = tpar.shard_trsv_schedule(one, _port(T), lower=lower, chunk=chunk)
    vals = [tchunk.with_slack(v, dt) for v in st.vals]
    x0 = _x0(np.random.default_rng(chunk), 8, st.nslots + 1, dt)
    xa, xb = x0.clone(), x0.clone()
    trsv_sharded.ag_chunk_loop(one, [xa], st.cols, vals, st.chunk,
                               st.nchunks)
    tchunk.chunk_sweep_plain(
        xb, tchunk.Sweep.all_gather(st.cols[0], vals[0], st.chunk))
    assert st.nchunks > 5
    assert torch.equal(xa, xb)
    assert not torch.equal(xa, x0)


def _halo_entry(op, b, dt):
    x = torch.zeros((op.D, op.buf_len), dtype=dt)
    bt = torch.as_tensor(np.append(b, 0.0), dtype=dt)
    x[:, :op.own_len] = bt[op.in_rows[0]]
    return x


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("chunk", [64, 256])
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_halo_sweep_plain_equals_chunk_loop(one, dname, chunk, lower):
    """The halo form with all three legs: the plain sweep equals the
    per-chunk loop (K10a, ``Mesh.shift``, ``Mesh.all_gather``) bit for bit,
    and the edge ranks' regions of the legs they have no sender for stay
    zero."""
    dt = DTYPES[dname]
    T = random_strict_triangular(N_LEGS, lower=lower, seed=SEED_LEGS)
    op = tpar.build_halo_op(one, _port(T), lower=lower, chunk=chunk,
                            dtype=np.dtype(dname))
    meta = np.asarray(op.meta)
    assert (meta[:, 1] > 0).any() and (meta[:, 3] > 0).any() \
        and (meta[:, 5] > 0).any(), "a leg kind is missing"
    b = np.random.default_rng(chunk).standard_normal(op.n)
    x0 = _halo_entry(op, b, dt)
    xa, xb = x0.clone(), x0.clone()
    halo_chunk_loop(op, [xa])
    tchunk.chunk_sweep_plain(xb, op.packed[0])
    assert torch.equal(xa, xb)
    for off_l, Wl, off_r, Wr, _, _ in op.meta:
        assert not xb[0, off_l:off_l + Wl].any()
        assert not xb[-1, off_r:off_r + Wr].any()
    # and the exit equals the solve
    xr = T.solve_as_strict_lower(b) if lower else T.solve_as_strict_upper(b)
    x = _np(tpar.halo_trsv_apply(op, b))
    np.testing.assert_allclose(x, xr, rtol=0,
                               atol=(1e-4 if dt == torch.float32 else 1e-10)
                               * np.abs(xr).max())


@pytest.mark.parametrize("chunk", [64, 256])
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_sharded_trsv_apply_sweep_equals_chunk_loop(one, monkeypatch, dname,
                                                    chunk):
    """``sharded_trsv_apply`` on the one-group mesh (the sweep) equals the
    same call with its chunk loop run a chunk at a time, bit for bit."""
    dt = DTYPES[dname]
    T = random_strict_triangular(500, lower=True, seed=6)
    st = tpar.shard_trsv_schedule(one, _port(T), lower=True, chunk=chunk)
    st = trsv_sharded.ShardedTrsv(
        one, st.in_rows, st.cols, [tchunk.with_slack(v, dt) for v in st.vals],
        st.out_slots, st.n, st.nchunks, st.chunk, st.nslots)
    b = np.random.default_rng(3).standard_normal(st.n)
    tchunk.chunk_sweep_plain.calls = 0
    x_sweep = tpar.sharded_trsv_apply(st, b)
    assert tchunk.chunk_sweep_plain.calls == 1
    monkeypatch.setattr(trsv_sharded, "chunk_sweep",
                        lambda x, sw: trsv_sharded.ag_chunk_loop(
                            one, [x], [sw.cols], [sw.vals], sw.chunk,
                            sw.nchunks))
    x_loop = tpar.sharded_trsv_apply(st, b)
    assert tchunk.chunk_sweep_plain.calls == 1
    assert x_sweep.dtype == dt
    assert torch.equal(x_sweep, x_loop)


@pytest.mark.parametrize("halo", [True, False])
@pytest.mark.parametrize("ranks", [16, 17, 32])
def test_wide_mesh_sweep_equals_chunk_loop(ranks, halo):
    """Meshes past a portable cluster's eight ranks (on the card 16 ranks
    run a non-portable cluster of 16 CTAs, 17 and 32 two ranks a CTA): the
    plain sweep equals the per-chunk loop bit for bit in both forms, and
    the solve through it equals the triangular solve."""
    dt = torch.float64
    mesh = make_mesh(ranks, device="cpu")
    T = random_strict_triangular(N_LEGS, lower=True, seed=SEED_LEGS)
    b = np.random.default_rng(ranks).standard_normal(N_LEGS)
    if halo:
        op = tpar.build_halo_op(mesh, _port(T), lower=True, chunk=64,
                                dtype=np.float64)
        assert op.D == ranks and len(op.packed) == 1
        x0 = _halo_entry(op, b, dt)
        xa, xb = x0.clone(), x0.clone()
        halo_chunk_loop(op, [xa])
        tchunk.chunk_sweep_plain(xb, op.packed[0])
        x = _np(tpar.halo_trsv_apply(op, b))
    else:
        st = tpar.shard_trsv_schedule(mesh, _port(T), lower=True, chunk=64)
        assert st.plan.form == "sweep" and st.plan.sweeps[0].ranks == ranks
        x0 = _x0(np.random.default_rng(ranks), ranks, st.nslots + 1, dt)
        xa, xb = x0.clone(), x0.clone()
        trsv_sharded.ag_chunk_loop(mesh, [xa], st.cols, st.vals, st.chunk,
                                   st.nchunks)
        tchunk.chunk_sweep_plain(xb, st.plan.sweeps[0])
        x = _np(tpar.sharded_trsv_apply(st, b))
    assert torch.equal(xa, xb) and not torch.equal(xa, x0)
    xr = T.solve_as_strict_lower(b)
    np.testing.assert_allclose(x, xr, rtol=0, atol=1e-10 * np.abs(xr).max())


@pytest.mark.parametrize("layout", ["one", "split"])
def test_halo_packed_views_match_jax_plan(layout):
    """``gcols``/``gvals``/``sends`` are views of each group's packed
    buffers (16-byte aligned chunk blocks, slack after each buffer), equal
    to the JAX plan's arrays; the records carry ``meta`` unchanged; and
    ``nbytes`` counts the packed buffers once."""
    mesh = make_mesh(8, device="cpu") if layout == "one" else Mesh(SPLIT)
    T = random_strict_triangular(N_LEGS, lower=True, seed=SEED_LEGS)
    jop = jpar.build_halo_op(jmake_mesh(8, rhs=1), T, lower=True, chunk=64)
    op = tpar.build_halo_op(mesh, _port(T), lower=True, chunk=64)
    _assert_halo_plans_equal(op, jop, mesh)
    assert len(op.packed) == len(mesh.groups())
    for gi, p in enumerate(op.packed):
        assert p.form == "halo" and p.ranks == mesh.groups()[gi].size
        np.testing.assert_array_equal(p.desc_host[:, 3:9], np.asarray(op.meta))
        assert (p.desc_host[:, 0] % 4 == 0).all()       # 16-byte blocks
        assert (p.desc_host[:, 2] % 2 == 0).all()
        np.testing.assert_array_equal(_np(p.desc), p.desc_host)
        for t in (p.cols, p.vals, p.sends):
            assert tchunk._tail_room(t) >= tchunk.SLACK
        base = {t.untyped_storage().data_ptr() for t in (p.cols, p.vals,
                                                         p.sends)}
        for c in range(op.nchunks):
            for v in (op.gcols[c][gi], op.gvals[c][gi],
                      *(leg[gi] for leg in op.sends[c])):
                assert v.untyped_storage().data_ptr() in base
    packed = sum(t.numel() * t.element_size()
                 for p in op.packed for t in p.tensors())
    idx = sum(t.numel() * t.element_size()
              for t in list(op.in_rows) + list(op.exit_pos))
    assert op.nbytes() == packed + idx


def _solve_counts(mesh, P, **kw):
    dp = DistPrec.from_host(mesh, P, chunk=64, **kw)
    ops = [op for lv in dp.levels for op in (lv.L_op, lv.U_op)
           if op.nchunks]
    tchunk.chunk_sweep_plain.calls = 0
    tchunk.chunk_sweep_peer_plain.calls = 0
    tchunk.chunk_fma_plain.calls = 0
    x = dp.solve(np.random.default_rng(5).standard_normal(P.precs[0].n))
    return (dp, ops, x, tchunk.chunk_sweep_plain.calls,
            tchunk.chunk_fma_plain.calls, tchunk.chunk_sweep_peer_plain.calls)


@pytest.mark.parametrize("form", ["chunk", "peer"])
@pytest.mark.parametrize("halo", [True, False])
def test_distprec_dispatch_by_layout(halo, form):
    """One group: every factor application is one sweep call and no K10a
    step runs; two groups in the ``"chunk"`` form (asked for): no sweep,
    one K10a step a chunk for each group; two groups in the ``"peer"`` form
    (the layout's own): one peer-sweep call a factor application, no K10a
    step and no sweep.  Every layout gives the same solve."""
    # the JAX distribution tests' operator, factorized with the port's
    # native library (two levels and a tail; the anchors end in a level
    # with m = n, which neither package's DistPrec takes)
    P = ht.HIF().factorize(_port(poisson2d(64)), ht.Options(**RED),
                           device="cpu")
    kw = dict(halo=halo, max_halo_chunks=10**6)
    dp, ops, x1, sweeps, fmas, peers = _solve_counts(
        make_mesh(8, device="cpu"), P, **kw)
    assert len(dp.levels) >= 2 and len(ops) >= 3
    assert sum(isinstance(op, HaloOp) for op in ops) == (len(ops) if halo
                                                         else 0)
    assert sweeps == 2 * len(ops) and fmas == 0 and peers == 0
    assert {op.plan.form for op in ops} == {"sweep"}
    mesh2 = Mesh(SPLIT)
    dp2, ops2, x2, sweeps2, fmas2, peers2 = _solve_counts(
        mesh2, P, form=None if form == "peer" else form, **kw)
    assert {op.plan.form for op in ops2} == {form}
    steps = 2 * sum(op.nchunks for op in ops2)
    if form == "chunk":
        assert sweeps2 == 0 and peers2 == 0
        assert fmas2 == len(mesh2.groups()) * steps
    else:
        assert sweeps2 == 0 and fmas2 == 0 and peers2 == 2 * len(ops2)
    xa, xb = _np(x1), _np(x2)
    np.testing.assert_allclose(xa, xb, rtol=0,
                               atol=1e-12 * np.abs(xa).max())


def test_sweep_kernel_entry_checks():
    """The card entry refuses CPU operands (the CPU runs the plain version
    only because its tensors lie there); a sweep refuses a chunk that is
    not every rank's, and slot vectors of the wrong shape or dtype."""
    cols = tchunk.with_slack(np.zeros((3, 8, 4, 2), np.int32))
    vals = tchunk.with_slack(np.zeros((3, 8, 4, 2)))
    sw = tchunk.Sweep.all_gather(cols, vals, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tchunk.ChunkSweepKernel(sw)
    with pytest.raises(ValueError, match="every rank"):
        tchunk.Sweep.all_gather(cols, vals, 16)
    with pytest.raises(ValueError, match="expected"):
        tchunk.chunk_sweep(torch.zeros((8, 96)), sw)
    with pytest.raises(TypeError, match="float32"):
        tchunk.chunk_sweep(torch.zeros((8, 97), dtype=torch.float32), sw)
    x = torch.zeros((8, 97), dtype=torch.float64)
    assert tchunk.chunk_sweep(x, sw) is x
    t = tchunk.with_slack(np.arange(5, dtype=np.float64))
    assert t.is_contiguous() and tchunk._tail_room(t) >= tchunk.SLACK
    np.testing.assert_array_equal(t.numpy(), np.arange(5.0))
