"""Handle-based runtime API mirroring the reference C library.

The port's copy of ``hifir_tpu/capi.py``, on the port's ``HIF``, ``CSR``,
``Options`` and ``hif_error``.  A host surface, as there: the solves are
``HIF.solve``, ``hifir`` and ``mmultiply`` on the host, and the C params
array cannot set ``device_tail`` or ``dist_schur``, so a handle created
through the C ABI touches no device.  ``create(device=...)`` is passed to
``HIF.factorize``, which uses it only for those two options.

Functional parity layer for ``libhifir``
(``libhifir/include/libhifir.h``): handle-based
preconditioners with a **sparsifier** S separate from the operator A
(``lhf?Create(A, S, params)``, libhifir.h:611), ``setup``/``update``/
``refactorize`` lifecycle (``:634-655``), the four apply modes
(``LHF_S``/``LHF_SH``/``LHF_M``/``LHF_MH`` with optional inner iterative
refinement and residual bounds, ``:685``), solve, and the stats/size queries
(``:716-740``).  Mixed precision (single-precision M applied to a
double-precision system, the ``lhfsd*`` functions, ``:1231-1282``) maps to
``precision="mixed"``.

This is the layer external bindings (and the serving runtime) talk to; being
plain functions over integer handles it is directly re-exportable over a C ABI
or RPC boundary.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Tuple

import numpy as np

from .api import HIF
from .ds.csr import CSR
from .options import Options, get_default_options
from .utils.log import hif_error

__all__ = [
    "OP_S", "OP_SH", "OP_M", "OP_MH",
    "create", "setup", "update", "refactorize", "destroy",
    "apply", "solve", "solve_mrhs", "get_stats", "get_nnz", "get_levels",
    "get_schur_size", "get_schur_rank", "is_mixed", "empty",
]

# apply operation modes (ref libhifir.h:669-676)
OP_S = 0    # x = M^{-1} b           (optionally with inner IR)
OP_SH = 1   # x = M^{-H} b
OP_M = 2    # x = M b
OP_MH = 3   # x = M^{H} b

_handles: Dict[int, dict] = {}
_next_id = itertools.count(1)


def _get(handle: int) -> dict:
    if handle not in _handles:
        hif_error("invalid preconditioner handle %d", handle)
    return _handles[handle]


def create(A=None, S=None, params: Optional[Options] = None,
           precision: str = "double", device="cuda") -> int:
    """Create a preconditioner handle (ref ``lhf?Create``, libhifir.h:611).

    ``A`` is the operator used by iterative refinement; ``S`` the sparsifier
    that is factorized (defaults to ``A`` — the common case; passing a sparser
    S is the reference's "sparsifier" feature, demo_sparsifier.cpp).
    ``precision``: "double" | "single" | "mixed" (single-precision M applied
    within a double-precision system, ref lhfsd*).  ``device`` is where
    ``HIF.factorize`` runs the dense tail's QRCP (``device_tail``) and the
    ring Schur (``dist_schur``); nothing else uses it.
    """
    h = next(_next_id)
    _handles[h] = {
        "A": None if A is None else _ascsr(A),
        "S": None if S is None else _ascsr(S),
        "params": params if params is not None else get_default_options(),
        "precision": precision,
        "device": device,
        "M": HIF(),
    }
    return h


def _ascsr(A) -> CSR:
    return A if isinstance(A, CSR) else CSR.from_scipy(A)


def setup(handle: int, S=None, params: Optional[Options] = None) -> None:
    """Factorize the sparsifier (ref ``lhf?Setup``, libhifir.h:634)."""
    st = _get(handle)
    if S is not None:
        st["S"] = _ascsr(S)
    if params is not None:
        st["params"] = params
    target = st["S"] if st["S"] is not None else st["A"]
    if target is None:
        hif_error("no matrix attached to handle")
    opts = st["params"]
    if st["precision"] in ("single", "mixed"):
        opts = opts.clone()
        opts.dtype = "float32"
    st["M"].factorize(target, opts, device=st["device"])


def update(handle: int, A) -> None:
    """Replace the IR operator A without refactorizing
    (ref ``lhf?Update``, libhifir.h:643)."""
    _get(handle)["A"] = _ascsr(A)


def refactorize(handle: int, S) -> None:
    """Replace and refactorize the sparsifier (ref ``lhf?Refactorize``)."""
    st = _get(handle)
    st["S"] = _ascsr(S)
    setup(handle)


def destroy(handle: int) -> None:
    _handles.pop(handle, None)


def empty(handle: int) -> bool:
    return _get(handle)["M"].empty()


def apply(handle: int, op: int, b: np.ndarray, nirs: int = 1,
          betas: Optional[Tuple[float, float]] = None, rank: int = 0
          ) -> Tuple[np.ndarray, int, int]:
    """Apply the preconditioner (ref ``lhf?Apply``, libhifir.h:685).

    Returns ``(x, iters, ir_status)``; ir_status follows the reference
    convention (0 converged / >0 diverged / <0 hit bound) and is 0 for plain
    applies.
    """
    st = _get(handle)
    M: HIF = st["M"]
    if M.empty():
        hif_error("apply on an empty preconditioner")
    b = np.asarray(b)
    if op in (OP_M, OP_MH):
        return M.mmultiply(b, trans=(op == OP_MH), r=rank), 1, 0
    trans = op == OP_SH
    if nirs <= 1:
        return M.solve(b, trans=trans, r=rank), 1, 0
    A = st["A"] if st["A"] is not None else st["S"]
    if A is None:
        hif_error("iterative refinement requires an operator (update())")
    if betas is None:
        x = M.hifir(A, b, nirs, trans=trans, r=rank)
        return x, nirs, 0
    x, iters, flag = M.hifir(A, b, nirs, betas=betas, trans=trans, r=rank)
    return x, iters, flag


def solve(handle: int, b: np.ndarray, trans: bool = False, rank: int = 0
          ) -> np.ndarray:
    """Plain M-solve (ref ``lhf?Solve``, libhifir.h:698)."""
    x, _, _ = apply(handle, OP_SH if trans else OP_S, b, 1, None, rank)
    return x


def solve_mrhs(handle: int, B: np.ndarray, trans: bool = False,
               rank: int = 0) -> np.ndarray:
    """Batched multi-RHS M-solve: X = M^{-1} B for an (n, k) block.

    EXTENSION over the reference C ABI: ``prec_solve_mrhs``
    (ref prec_solve.hpp:428) is only reachable from its C++ ``solve_mrhs``
    (builder.hpp), never exported through libhifir.h; here the C surface
    gets it too (``lhf?SolveMrhs``)."""
    st = _get(handle)
    M: HIF = st["M"]
    if M.empty():
        hif_error("apply on an empty preconditioner")
    return M.solve_mrhs(np.asarray(B), r=rank, trans=trans)


def get_stats(handle: int) -> np.ndarray:
    """Deferral/dropping counters (ref ``lhf?GetStats``, libhifir.h:716)."""
    return _get(handle)["M"].stats_.copy()


def get_nnz(handle: int) -> int:
    return _get(handle)["M"].nnz()


def get_levels(handle: int) -> int:
    return _get(handle)["M"].levels()


def get_schur_size(handle: int) -> int:
    return _get(handle)["M"].schur_size()


def get_schur_rank(handle: int) -> int:
    return _get(handle)["M"].schur_rank()


def is_mixed(handle: int) -> bool:
    return _get(handle)["precision"] == "mixed"
