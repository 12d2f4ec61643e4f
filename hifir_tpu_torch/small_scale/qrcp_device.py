"""K8: Householder QR with column pivoting on the device of its input.

The port of ``hifir_tpu/small_scale/qrcp_device.py:qrcp_device`` (a
``lax.fori_loop`` of n steps in one ``jax.jit``), not of LAPACK's
``geqp3``: the same greedy pivoting on downdated column norms, the same
reflectors and the same clamp, so that the pivots, Q and R follow the JAX
package's sweep.  On the GPU it replaces the host ``geqp3`` of the dense
tail (``Options.device_tail``, ``DevicePrec.from_host(tail_on_device=True)``).

:func:`qrcp_device` dispatches on the device of its input:

- on the card, :func:`qrcp_device_cuda` runs the whole loop as one
  cooperative launch of ``csrc/kernels.cu:qrcp_kernel`` (one grid barrier a
  column step; the kernel's note gives its design), in the first layout of
  :data:`LAYOUTS` whose shared memory fits (:func:`qrcp_layout`), so that
  no n is refused for shared memory;
- on the CPU, :func:`qrcp_device_plain` runs the plain version: one Python
  loop of n steps, each a fixed sequence of tensor operations (masked
  argmax, column swap, reflector, two rank-1 updates, cleanup, norm
  downdate).  It reads no device value on the host (the pivot stays a 0-d
  tensor and the swap is an index tensor built with ``torch.where`` on an
  ``arange``, as the JAX code builds it), so on the card, where the
  comparisons run it, it queues its ~45 launches a step without a
  synchronisation.

Neither makes a host sync; :func:`qrcp_rank` syncs once, after.  Bound on
the card: A read once and Q and R written once (3 n^2 elements), and
(8/3) n^3 FLOP at the dtype's peak; at the tails' sizes (n of a few
hundred) both are microseconds, and the chain of n dependent steps sets the
time.  :func:`qrcp_factor` is the one entry that the dense-tail
factorizations call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ..kernels.build import check, dtype_suffix, kernel_fn, load_kernels

__all__ = ["qrcp_device", "qrcp_device_plain", "qrcp_device_cuda",
           "qrcp_plan", "qrcp_layout", "qrcp_smem", "qrcp_vec_bytes",
           "qrcp_rank", "qrcp_factor", "LAYOUTS"]


def _check(A: torch.Tensor, who: str) -> None:
    if A.is_complex():
        raise TypeError(f"{who}: the column-norm sweep is real only; got "
                        f"{A.dtype} (a complex tail takes the host QRCP)")
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"{who}: square A expected, got {tuple(A.shape)}")


def qrcp_device(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Factorize A[:, piv] = Q R with |diag(R)| non-increasing, on A's
    device and in A's dtype (float32 or float64).

    Returns (Q, R, piv), piv int64.  Square A only (the HIF dense tail is
    square).  A complex A raises TypeError: the column-norm sweep
    ``(A * A).sum(0)`` is real only, as in the JAX package.  Kernel K8 for
    a CUDA tensor, the plain version for a CPU one;
    ``qrcp_device.calls`` counts the calls."""
    _check(A, "qrcp_device")
    qrcp_device.calls += 1
    if A.device.type == "cpu":
        return qrcp_device_plain(A)
    return qrcp_device_cuda(A)


qrcp_device.calls = 0


def qrcp_device_plain(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """The plain version of K8: the JAX loop as eager torch operations, on
    A's device.  ``qrcp_device_plain.calls`` counts its calls."""
    _check(A, "qrcp_device_plain")
    qrcp_device_plain.calls += 1
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


qrcp_device_plain.calls = 0


# The kernel's layouts, in the order the host tries them (csrc/kernels.cu:
# kQrcpShared, kQrcpGlobal, kQrcpGlobalX): the slabs of R and Q in shared
# memory; the slabs in global memory; x, the map and its inverse in global
# memory too, each CTA its own copy.
LAYOUTS = ("shared", "global", "global_x")
_WARPS = 16     # kernels.cu:kQrcpWarps
# columns (and rows of Q) a CTA, at least: fewer, fuller CTAs shorten the
# step at the tails' sizes (tools/probe_qrcp.py's sweep, PERF.md section 6)
_MIN_COLS = 8


def _round16(b: int) -> int:
    return -(-b // 16) * 16


def qrcp_vec_bytes(n: int, itemsize: int) -> int:
    """Bytes of x, the map and its inverse (kernels.cu:qrcp_vec_bytes)."""
    return _round16(n * itemsize) + 2 * _round16(4 * n)


def qrcp_smem(n: int, cols: int, itemsize: int, layout: str) -> int:
    """A CTA's dynamic shared memory in ``layout`` (kernels.cu:qrcp_smem):
    its columns' norms and the warps' partial sums, then x, the map and
    its inverse unless "global_x", then the R and Q slabs if "shared"."""
    b = _round16(cols * itemsize) + _round16((_WARPS + 1) * itemsize)
    if layout != "global_x":
        b += qrcp_vec_bytes(n, itemsize)
    if layout == "shared":
        b += 2 * _round16(cols * n * itemsize)
    return b


def qrcp_layout(n: int, itemsize: int, sms: int, max_smem: int,
                cols_per_cta: int = 0, layout=None) -> dict:
    """K8's launch shape on a card of ``sms`` SMs whose blocks may hold
    ``max_smem`` bytes of shared memory: the columns a CTA (``cols_per_cta``
    or the default, at least 8 and one CTA an SM), the grid, the first
    layout of :data:`LAYOUTS` that fits (or ``layout``, which must fit) and
    its shared memory.  Plain arithmetic, the one place the layout is
    chosen; the C plan checks it against the card."""
    if n < 1 or cols_per_cta < 0:
        raise ValueError(f"qrcp_layout: n = {n}, cols_per_cta = "
                         f"{cols_per_cta}")
    cols = min(cols_per_cta or max(_MIN_COLS, -(-n // sms)), n)
    if layout is None:
        layout = next((x for x in LAYOUTS
                       if qrcp_smem(n, cols, itemsize, x) <= max_smem),
                      LAYOUTS[-1])
    elif layout not in LAYOUTS:
        raise ValueError(f"qrcp_layout: layout {layout!r} not in {LAYOUTS}")
    smem = qrcp_smem(n, cols, itemsize, layout)
    if smem > max_smem:
        raise ValueError(f"qrcp_layout: n = {n} at {cols} columns a CTA in "
                         f"the {layout} layout needs {smem} bytes of shared "
                         f"memory, more than a block's {max_smem}")
    return dict(grid=-(-n // cols), cols=cols, layout=layout, smem=smem)


@functools.lru_cache(maxsize=64)
def _plan(device_index: int, n: int, dtype, cols_per_cta: int, layout):
    with torch.cuda.device(device_index):
        kl = load_kernels()
        sms = torch.cuda.get_device_properties(
            device_index).multi_processor_count
        plan = qrcp_layout(n, torch.empty((), dtype=dtype).element_size(),
                           sms, kl.lib.hifir_max_smem(), cols_per_cta, layout)
        out = (ctypes.c_int * 2)()
        err = kl.fn("qrcp_plan", dtype_suffix("qrcp", dtype))(
            n, plan["cols"], LAYOUTS.index(plan["layout"]), out)
    check(err, f"qrcp: plan for n = {n} ({plan['cols']} columns a CTA, "
          f"{plan['layout']} layout)")
    if (out[0], out[1]) != (plan["grid"], plan["smem"]):
        raise RuntimeError(f"qrcp: the kernel's plan (grid {out[0]}, "
                           f"{out[1]} bytes) differs from the host's {plan}")
    return plan


def qrcp_plan(n: int, dtype, device="cuda", cols_per_cta: int = 0,
              layout=None) -> dict:
    """K8's launch for an n x n factorization on ``device``
    (:func:`qrcp_layout` at the card's SMs and shared memory, checked by
    the kernel's plan): the grid (one CTA per ``cols`` columns of R and
    rows of Q, all co-resident), the layout and the dynamic shared memory
    a CTA.  ``cols_per_cta`` > 0 asks for that many columns a CTA and
    ``layout`` for a layout of :data:`LAYOUTS`; a grid that cannot be
    co-resident raises."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return dict(_plan(idx, n, dtype, cols_per_cta, layout))


def qrcp_device_cuda(A: torch.Tensor, cols_per_cta: int = 0, layout=None):
    """Launch K8 on A's card: (Q, R, piv) as :func:`qrcp_device_plain`
    gives them, in one cooperative launch on the current stream, with no
    host sync (``cols_per_cta`` and ``layout`` as :func:`qrcp_plan` takes
    them).  Refuses a complex, non-square or CPU A, and a dtype other
    than float32 and float64, before it loads the library.
    ``qrcp_device_cuda.launches`` counts its launches."""
    _check(A, "qrcp_device_cuda")
    dtype_suffix("qrcp", A.dtype)
    if A.device.type != "cuda":
        raise ValueError(f"qrcp_device_cuda: a CUDA tensor expected, got "
                         f"one on {A.device}")
    n = A.shape[0]
    Q = torch.empty((n, n), dtype=A.dtype, device=A.device)
    R = torch.empty_like(Q)
    piv = torch.empty(n, dtype=torch.int64, device=A.device)
    if n == 0:
        return Q, R, piv
    A = A.contiguous()
    plan = qrcp_plan(n, A.dtype, A.device, cols_per_cta, layout)
    G, lay = plan["grid"], plan["layout"]
    # R's column-major scratch copy for the global layouts, each CTA's x,
    # map and inverse for "global_x"; the CTAs' candidates (two buffers, by
    # the step's parity)
    rt = A.new_empty(n * n if lay != "shared" else 0)
    vec = torch.empty(G * qrcp_vec_bytes(n, A.element_size())
                      if lay == "global_x" else 0, dtype=torch.uint8,
                      device=A.device)
    cand_col = A.new_empty(2 * G * n)
    cand_norm = A.new_empty(2 * G)
    cand_pos = torch.empty(2 * G, dtype=torch.int32, device=A.device)
    fn = kernel_fn("qrcp", index_dtypes=(torch.int64, torch.uint8,
                                         torch.int32),
                   A=A, Q=Q, R=R, piv=piv, rt=rt, vec=vec, cand_col=cand_col,
                   cand_norm=cand_norm, cand_pos=cand_pos)
    err = fn(A.data_ptr(), n, plan["cols"], LAYOUTS.index(lay), G,
             Q.data_ptr(), R.data_ptr(), piv.data_ptr(), rt.data_ptr(),
             vec.data_ptr(), cand_col.data_ptr(),
             cand_norm.data_ptr(), cand_pos.data_ptr(),
             torch.cuda.current_stream(A.device).cuda_stream)
    check(err, "qrcp")
    qrcp_device_cuda.launches += 1
    return Q, R, piv


qrcp_device_cuda.launches = 0


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
