"""K8: Householder QR with column pivoting on the device of its input.

The port of ``hifir_tpu/small_scale/qrcp_device.py:qrcp_device`` (a
``lax.fori_loop`` of n steps in one ``jax.jit``), not of LAPACK's
``geqp3``: the same greedy pivoting on downdated column norms, the same
reflectors and the same clamp, so that the pivots, Q and R follow the JAX
package's sweep.  On the GPU it replaces the host ``geqp3`` of the dense
tail (``Options.device_tail``, ``DevicePrec.from_host(tail_on_device=True)``).

The route is eager PyTorch (a "torch route", not a hand-written kernel):
one Python loop of n steps, each a fixed sequence of tensor operations
(masked argmax, column swap, reflector, two rank-1 updates, cleanup, norm
downdate).  Nothing in the loop reads a device value on the host: the pivot
stays a 0-d tensor and the swap is an index tensor built with
``torch.where`` on an ``arange``, as the JAX code builds it, so the loop
queues its launches without a synchronisation.  :func:`qrcp_rank` syncs
once, after the loop.  Bound on the card: A read once and Q and R written
once (3 n^2 elements), and (8/3) n^3 FLOP (R's reflections and Q's
accumulation) at the dtype's peak; at the tails' sizes (n of a few hundred)
both are microseconds, and the launches (about 45 a step) set its time.
:func:`qrcp_factor` is the one entry that the dense-tail factorizations
call.

The same code is the plain version: on the CPU it runs as it is.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["qrcp_device", "qrcp_rank", "qrcp_factor"]


def qrcp_device(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Factorize A[:, piv] = Q R with |diag(R)| non-increasing, on A's
    device and in A's dtype (float32 or float64).

    Returns (Q, R, piv), piv int64.  Square A only (the HIF dense tail is
    square).  A complex A raises TypeError: the column-norm sweep
    ``(A * A).sum(0)`` is real only, as in the JAX package."""
    if A.is_complex():
        raise TypeError("qrcp_device: the column-norm sweep is real only; "
                        f"got {A.dtype} (a complex tail takes the host QRCP)")
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"qrcp_device: square A expected, got "
                         f"{tuple(A.shape)}")
    qrcp_device.calls += 1
    n = A.shape[0]
    dev, dt = A.device, A.dtype
    R = A.clone()
    Q = torch.eye(n, dtype=dt, device=dev)
    piv = torch.arange(n, device=dev)
    norms2 = (A * A).sum(dim=0)
    idx = torch.arange(n, device=dev)
    for k in range(n):
        # greedy pivot among the trailing columns
        j = torch.argmax(torch.where(idx >= k, norms2, -torch.inf))
        # swap columns k <-> j by a gather through a permutation
        swap = torch.where(idx == k, j, torch.where(idx == j, k, idx))
        R = R[:, swap]
        piv = piv[swap]
        norms2 = norms2[swap]
        # Householder vector for column k below row k
        x = torch.where(idx >= k, R[:, k], 0.0)
        sigma = torch.linalg.vector_norm(x)
        xk = R[k, k]
        alpha = -torch.sign(torch.where(xk == 0, 1.0, xk)) * sigma
        v = x.clone()
        v[k] -= alpha
        vnorm = torch.linalg.vector_norm(v)
        v = torch.where(vnorm > 0, v / torch.where(vnorm > 0, vnorm, 1.0), v)
        # apply the reflector: R -= 2 v (v^T R);  Q -= 2 (Q v) v^T
        R = R - 2.0 * torch.outer(v, v @ R)
        Q = Q - 2.0 * torch.outer(Q @ v, v)
        # clean the annihilated entries and set the diagonal exactly
        col = torch.where(idx > k, 0.0, R[:, k])
        col[k] = alpha
        R[:, k] = col
        # downdate the trailing column norms; clamp the drift
        norms2 = torch.clamp_min(norms2 - R[k, :] ** 2, 0.0)
    return Q, torch.triu(R), piv


qrcp_device.calls = 0


def qrcp_rank(R: torch.Tensor, rrqr_cond: float = 0.0) -> int:
    """The rank from |diag R|'s decay against ``rrqr_cond`` (default
    eps^{-2/3}; ref QRCP.hpp:144-161): one copy of the diagonal to the
    host."""
    d = np.abs(R.diagonal().cpu().numpy())
    if d.size == 0 or d[0] == 0.0:
        return 0
    if rrqr_cond <= 0.0:
        rrqr_cond = float(np.finfo(np.float64).eps) ** (-2.0 / 3.0)
    good = d > d[0] / rrqr_cond
    return int(np.flatnonzero(good)[-1] + 1) if good.any() else 0


def qrcp_factor(A: torch.Tensor, rrqr_cond: float = 0.0):
    """K8 and its rank: (Q, R, piv, rank) of A on A's device, the rank by
    :func:`qrcp_rank` at ``rrqr_cond``.  ``DeviceQRCP`` passes its options'
    ``rrqr_cond``; ``DevicePrec.from_host(tail_on_device=True)`` passes the
    default, as the JAX package's does."""
    Q, R, piv = qrcp_device(A)
    return Q, R, piv, qrcp_rank(R, rrqr_cond)
