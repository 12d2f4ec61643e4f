"""Entry points: the single-device M-solve and a multi-rank dry run.

The port of ``__graft_entry__.py``.  :func:`entry` returns the flagship
computation, the batched multilevel M-solve on a factorized
convection-diffusion system; :func:`dryrun_multichip` builds a
``(rhs, rows)`` mesh of ranks and runs two sharded iterative-refinement
steps (row-sharded SpMV, all_gather, batched M-solve) and a fully
distributed M-solve (:class:`~hifir_tpu_torch.parallel.DistPrec`) on small
shapes.

Left out, as the port has no counterpart: the XLA compile cache (a
captured graph lives in its pack's cache, for the life of the process) and
the ``XLA_FLAGS`` / ``jax_platforms`` handling.  In the port the ranks of a
device are the rows of one tensor, so every rank count runs on one card (or
on the CPU with ``device="cpu"``); given ``devices``, the dry run puts one
rank on each listed device, as the JAX dry run's ``make_mesh(n_devices)``
puts one on each chip.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]

# __graft_entry__.py:_small_prec's options
SMALL_OPTS = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5,
                  kappa_d=5, verbose=0, dense_thres=30)


def _small_prec(nx: int = 16):
    from .api import HIF
    from .models.problems import convdiff2d
    from .options import Options

    A = convdiff2d(nx)
    M = HIF().factorize(A, Options(**SMALL_OPTS), device="cpu")
    return A, M


def entry(device="cuda"):
    """Return ``(fn, args)``: the batched multilevel M-solve
    ``fn(*args) = M^{-1} B`` on convdiff2d(12), packed in float32 with
    ``chunk=1024``, and B = ones((n, 8)) on ``device``.

    As the JAX entry returns its jitted ``prec_solve_mrhs_device`` with the
    pytrees of ``DevicePrec.operands()``, ``fn`` is
    :func:`~hifir_tpu_torch.alg.prec.prec_solve_mrhs` compiled against the
    pack (:func:`~hifir_tpu_torch.graphs.jit`: on the card its first call
    runs it and captures the graph, every later call replays; on the CPU it
    runs eagerly) and ``args`` are ``operands()`` and B."""
    from .alg.prec import DevicePrec, prec_solve_mrhs
    from .device import resolve_device
    from .graphs import jit

    dev = resolve_device(device)
    A, M = _small_prec(nx=12)
    dp = DevicePrec.from_host(M.precs, dtype=np.float32, chunk=1024,
                              device=dev)
    B = torch.ones((A.nrows, 8), dtype=torch.float32, device=dev)
    return jit(dp, prec_solve_mrhs), (*dp.operands(), B)


def dryrun_multichip(n_ranks: int, device="cuda", devices=None) -> dict:
    """Two sharded IR steps and one distributed M-solve over ``n_ranks``
    ranks on ``device`` or, given ``devices`` (``n_ranks`` of them, which
    may repeat), rank k on ``devices[k]``, with the asserts of the JAX dry
    run.

    The IR steps run on convdiff2d(16), A row-sharded, on a mesh with
    ``rhs=2`` for an even rank count above one (else 1): the result is
    finite and the residual falls.  Then a :class:`DistPrec` of
    convdiff2d(40) (three levels at these options) with ``chunk=4 *
    n_ranks`` on a ``rows`` mesh: on more than one rank the halo trsv
    engages, some level's L runs at least 8 chunks and the exchange moves
    fewer elements than the tiled all_gather would; its solve is finite
    and within 1e-8 (float64) of max|x| of the host solve.  The IR steps
    and the DistPrec solve run through the graph layer (on the card a
    program's first call captures it and later calls replay it: the
    second IR step and every later ``dist.solve`` of the same shape are
    replays; on the CPU they run eagerly).  Returns the IR residuals
    (``ir_residual0``, ``ir_residual2``), the DistPrec (``dist``), its
    solution ``x``, the host's ``x_host`` and the host factorization
    ``M``."""
    from .device import resolve_device
    from .parallel import (DistPrec, make_mesh, make_sharded_ir_step,
                           shard_ell_rows)
    from .parallel.trsv_halo import HaloOp

    if devices is not None and len(devices) != n_ranks:
        raise ValueError(f"{len(devices)} devices for {n_ranks} ranks: the "
                         "dry run puts one rank on each")
    dev = resolve_device(device if devices is None else devices[0])
    rhs_axis = 2 if n_ranks % 2 == 0 and n_ranks > 1 else 1
    mesh = make_mesh(n_ranks, rhs=rhs_axis, device=dev, devices=devices)
    A, M = _small_prec()
    n = A.nrows
    Ae = shard_ell_rows(mesh, A)
    dp = M.to_device(device=dev)
    step = make_sharded_ir_step(mesh, n)
    nrhs = 2 * rhs_axis
    npad = Ae.nrows
    B = torch.zeros((npad, nrhs), dtype=torch.float64, device=dev)
    B[:n] = 1.0
    X = torch.zeros_like(B)
    X = step(Ae, dp.levels, dp.tail, X, B)
    X = step(Ae, dp.levels, dp.tail, X, B)
    Xn = X.cpu().numpy()
    assert np.all(np.isfinite(Xn)), \
        "sharded IR step produced non-finite values"
    # one step of IR is exactly M^{-1}B; sanity: residual must drop
    Bn = B.cpu().numpy()
    r0 = float(np.linalg.norm(Bn[:n]))
    r2 = max(float(np.linalg.norm(Bn[:n, k] - A.matvec(Xn[:n, k])))
             for k in range(nrhs))
    assert r2 < r0, "sharded IR did not reduce the residual"

    # the fully distributed M-solve: sharded factors, per-chunk compact
    # halo exchange; a bigger system than the IR step's, so that the trsv
    # runs many chunks a level (>= 8) over >= 3 levels
    A2, M2 = _small_prec(nx=40)
    n2 = A2.nrows
    mesh_rows = make_mesh(n_ranks, rhs=1, device=dev, devices=devices)
    dpp = DistPrec.from_host(mesh_rows, M2, chunk=4 * n_ranks)
    if n_ranks > 1:
        assert dpp.n_halo > 0, "halo trsv did not engage"
        assert any(isinstance(lv.L_op, HaloOp) and lv.L_op.nchunks >= 8
                   for lv in dpp.levels), "dryrun too small: <8 chunks/level"
        assert dpp.comm_elems < dpp.allgather_elems
    xb = dpp.solve(np.ones(n2)).cpu().numpy()
    assert np.all(np.isfinite(xb)), "distributed M-solve non-finite"
    xh = M2.solve(np.ones(n2))
    tol = 1e-8 if xb.dtype == np.float64 else 1e-3
    assert np.abs(xb - xh).max() <= tol * max(1.0, np.abs(xh).max()), \
        "distributed M-solve deviates from host"
    return dict(ir_residual0=r0, ir_residual2=r2, dist=dpp, x=xb, x_host=xh,
                M=M2)
