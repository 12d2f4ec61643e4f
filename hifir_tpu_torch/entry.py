"""Entry points: the single-device M-solve and a multi-rank dry run.

The port of ``__graft_entry__.py``.  :func:`entry` returns the flagship
computation, the batched multilevel M-solve on a factorized
convection-diffusion system; :func:`dryrun_multichip` builds a
``(rhs, rows)`` mesh of ranks and runs two sharded iterative-refinement
steps (row-sharded SpMV, all_gather, batched M-solve) and a fully
distributed M-solve (:class:`~hifir_tpu_torch.parallel.DistPrec`) on small
shapes.

Left out, as the port has no counterpart: the XLA compile cache, the
``XLA_FLAGS`` / ``jax_platforms`` handling and the ``len(jax.devices())``
check.  In the port a mesh's ranks are the rows of one tensor on a device,
so every rank count runs on one card (or on the CPU with
``device="cpu"``).
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

    The JAX entry returns its jittable ``prec_solve_mrhs_device`` with the
    pytrees of ``DevicePrec.operands()``.  The port has no jit layer and no
    ``operands()``: ``fn`` is the eager
    :func:`~hifir_tpu_torch.alg.prec.prec_solve_mrhs` and ``args`` are the
    pack's ``levels`` and ``tail`` (tensors on ``device``) and B, so that
    ``fn(*args)`` launches the kernels directly."""
    from .alg.prec import DevicePrec, prec_solve_mrhs
    from .device import resolve_device

    dev = resolve_device(device)
    A, M = _small_prec(nx=12)
    dp = DevicePrec.from_host(M.precs, dtype=np.float32, chunk=1024,
                              device=dev)
    B = torch.ones((A.nrows, 8), dtype=torch.float32, device=dev)
    return prec_solve_mrhs, (dp.levels, dp.tail, B)


def dryrun_multichip(n_ranks: int, device="cuda") -> dict:
    """Two sharded IR steps and one distributed M-solve over ``n_ranks``
    ranks on ``device``, with the asserts of the JAX dry run.

    The IR steps run on convdiff2d(16), A row-sharded, on a mesh with
    ``rhs=2`` for an even rank count above one (else 1): the result is
    finite and the residual falls.  Then a :class:`DistPrec` of
    convdiff2d(40) (three levels at these options) with ``chunk=4 *
    n_ranks`` on a ``rows`` mesh: on more than one rank the halo trsv
    engages, some level's L runs at least 8 chunks and the exchange moves
    fewer elements than the tiled all_gather would; its solve is finite
    and within 1e-8 (float64) of max|x| of the host solve.  Returns the
    IR residuals (``ir_residual0``, ``ir_residual2``), the DistPrec
    (``dist``), its solution ``x``, the host's ``x_host`` and the host
    factorization ``M``."""
    from .device import resolve_device
    from .parallel import (DistPrec, make_mesh, make_sharded_ir_step,
                           shard_ell_rows)
    from .parallel.trsv_halo import HaloOp

    dev = resolve_device(device)
    rhs_axis = 2 if n_ranks % 2 == 0 and n_ranks > 1 else 1
    mesh = make_mesh(n_ranks, rhs=rhs_axis, device=dev)
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
    mesh_rows = make_mesh(n_ranks, rhs=1, device=dev)
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
