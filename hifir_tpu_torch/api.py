"""User-facing preconditioner object of the port.

The counterpart of ``hifir_tpu.api.HIF`` (ref ``src/hif/builder.hpp:109-601``):
:meth:`HIF.factorize` builds the multilevel preconditioner on the host
(:mod:`.alg.factor`: matching, ordering, the Crout levels in the native
host library or the numpy anchors, and the dense tail, whose QRCP runs on
the GPU with ``Options.device_tail=1``), or :func:`load_prec` reads one
that ``save_prec`` wrote.  ``solve``/``solve_mrhs``/``hifir``/``mmultiply``
apply it on the host, as the JAX package does; :meth:`HIF.to_device` packs
it onto a device, whose ``pack_transpose``, ``pack_prod`` and
``pack_prod_tran`` take ``HIF.precs``.  The device GMRES drivers and the
null-space filter are exported here too; the host drivers are
:mod:`.solvers.gmres_np`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .alg.factor import level_factorize
from .alg.iter_refine import iter_refine
from .alg.level import LevelPrec
from .alg.prec_solve_np import prec_prod_np, prec_prod_tran_np, prec_solve_np
from .alg.prec import DevicePrec
from .ds.csr import CSR
from .nsp import NspFilter
from .options import Options, get_default_options
from .small_scale.dense import make_dense_solver
from .solvers.gmres import fgmres_hifir, gmres_hif, gmres_mrhs
from .trace import snapshot, span
from .utils.log import hif_error, hif_info, hif_warning, verbose_enabled
from .utils.serialize import load_prec, prec_from_arrays, save_prec

__all__ = ["HIF", "load_prec", "save_prec", "prec_from_arrays", "NspFilter",
           "gmres_hif", "fgmres_hifir", "gmres_mrhs"]


def _classify_symmetry(A: CSR) -> int:
    """0 = neither; 1 = exactly A == A^T (values); 2 = exactly A == A^H
    (complex only).  Real input takes the native O(nnz) test
    (``ht_value_symm``) when the library is loaded; otherwise, and for
    complex input, the sorted CSR of A is compared with its transpose
    (fail-closed on structure, like the native test)."""
    if A.data.dtype.kind not in "fc":
        return 0
    if A.data.dtype in (np.float64, np.float32):
        from .pre import _native

        vs = _native.value_symm(A.nrows, A.indptr, A.indices,
                                A.data.astype(np.float64, copy=False))
        if vs is not None:
            return int(vs)
    As = A.to_scipy().tocsr()
    As.sort_indices()
    AT = As.T.tocsr()
    AT.sort_indices()
    if not (np.array_equal(As.indptr, AT.indptr)
            and np.array_equal(As.indices, AT.indices)):
        return 0
    if np.array_equal(As.data, AT.data):
        return 1
    if np.iscomplexobj(A.data) and np.array_equal(As.data, np.conj(AT.data)):
        return 2
    return 0


# the factorize's phases (spans of :mod:`.trace`) in its timing report
_PHASES = (("preprocessing", "hifir.factorize.pre"),
           ("crout", "hifir.factorize.crout"),
           ("schur", "hifir.factorize.schur"),
           ("dense tail", "hifir.factorize.tail"))


def _report_phases(opts, before: dict, total: float) -> None:
    """The ``VERBOSE_PRE_TIME`` lines: each phase's seconds in the
    factorize just done (its spans' gains since ``before``) and the
    total."""
    now = snapshot()["spans"]
    for label, name in _PHASES:
        sec = now.get(name, (0.0, 0))[0] - before.get(name, (0.0, 0))[0]
        hif_info(opts, "time: %s %gs", label, sec, tag="pre_time")
    hif_info(opts, "time: factorize %gs", total, tag="pre_time")


class HIF:
    """Hybrid incomplete factorization held on the host."""

    def __init__(self, precs: List[LevelPrec] = ()):
        self.precs = list(precs)
        self.stats_ = np.zeros(6, dtype=np.int64)
        self.nsp = None        # null-space filter (NspFilter) of solve
        self.nsp_tran = None   # left null-space filter of solve(trans=True)

    # -- state accessors (ref builder.hpp:141-234) --------------------------
    def empty(self) -> bool:
        return not self.precs

    def levels(self) -> int:
        """Level count; the dense tail counts as one level
        (ref builder.hpp:141-147)."""
        if not self.precs:
            return 0
        return len(self.precs) + (self.precs[-1].dense_solver is not None)

    def nnz(self) -> int:
        return sum(p.nnz() for p in self.precs)

    def nnz_ef(self) -> int:
        return sum(p.nnz_ef() for p in self.precs)

    def nnz_ldu(self) -> int:
        return sum(p.nnz_ldu() for p in self.precs)

    def rank(self) -> int:
        """Numerical rank: accepted block sizes + dense tail rank."""
        return sum(p.m for p in self.precs) + self.schur_rank()

    def schur_rank(self) -> int:
        last = self.precs[-1] if self.precs else None
        if last is None or last.dense_solver is None:
            return 0
        return last.dense_solver.rank

    def schur_size(self) -> int:
        return self.precs[-1].n - self.precs[-1].m if self.precs else 0

    def stats(self, entry: int) -> int:
        """Deferral/dropping counters (ref builder.hpp:204-234)."""
        return int(self.stats_[entry])

    def clear(self) -> None:
        self.precs = []
        self.stats_[:] = 0

    # -- factorization ------------------------------------------------------
    def factorize(self, A, params: Optional[Options] = None, m0: int = 0,
                  device="cuda") -> "HIF":
        """Build the multilevel preconditioner (ref builder.hpp:264-399).

        ``A`` is a :class:`~hifir_tpu_torch.ds.csr.CSR` or anything scipy
        turns into CSR.  ``device`` is where the dense tail's QRCP runs when
        ``params.device_tail`` is set (K8) and where the ring Schur SpGEMM's
        ranks live when ``params.dist_schur`` is set; nothing else uses
        it."""
        opts = params if params is not None else get_default_options()
        if not isinstance(A, CSR):
            A = CSR.from_scipy(A)
        if opts.check:
            A.check_validity()
        if A.nrows != A.ncols:
            hif_error("only square systems are supported")
        if not 0 <= m0 <= A.nrows:
            hif_error("m0 (symmetric leading block size) must be in [0, n]; "
                      "got %d for n=%d" % (m0, A.nrows))
        self.clear()
        # single precision runs the whole level pipeline on f32/c64
        # operands (the reference's HIF<float>); an explicit f64 request
        # upcasts single-precision input
        if opts.dtype == "float32":
            want = np.complex64 if np.iscomplexobj(A.data) else np.float32
            if A.data.dtype != want:
                A = A.astype(want)
        elif opts.dtype == "float64" and A.data.dtype in (np.float32,
                                                          np.complex64):
            A = A.astype(np.complex128 if np.iscomplexobj(A.data)
                         else np.float64)

        # LDL^T / LDL^H dispatch on a provably symmetric or Hermitian input
        # (the JAX package's symm_detect); m0 > 0 keeps the reference's
        # declared-leading-block semantics instead
        if (opts.symm_detect and not opts.is_symm and m0 == 0
                and not opts.no_pre):
            kind = _classify_symmetry(A)
            if kind:
                opts = dataclasses.replace(opts, is_symm=1, symm_kind=kind)
                hif_info(opts, "detected exactly %s input; using the "
                               "LDL^%s path (symm_detect=0 disables)",
                         "Hermitian" if kind == 2 else "symmetric",
                         "H" if kind == 2 else "T")
        elif (opts.is_symm and not opts.symm_kind
                and np.iscomplexobj(A.data)):
            # user-declared is_symm on complex input: classify so the kernel
            # knows whether the mirror conjugates; neither -> general path
            kind = _classify_symmetry(A)
            if kind:
                opts = dataclasses.replace(opts, symm_kind=kind)
            else:
                hif_warning("is_symm set but the complex input is neither "
                            "exactly symmetric nor Hermitian; using the "
                            "general LDU path")
                opts = dataclasses.replace(opts, is_symm=0)
        before = snapshot()["spans"]
        with span("hifir.factorize") as whole:
            N = opts.N if opts.N >= 0 else A.nrows
            row_sizes = np.empty(0, dtype=np.int64)
            col_sizes = np.empty(0, dtype=np.int64)
            S: Optional[CSR] = A
            level = 1
            while S is not None:
                m_in = S.nrows if (level > 1 or not m0) else m0
                # ref builder.hpp:534-535: a user-declared leading block
                # (m0 > 0) at level 1 selects the symmetric-block mirror
                # factorization
                with span("hifir.factorize.level"):
                    prec, S, row_sizes, col_sizes = level_factorize(
                        S, m_in if m_in else S.nrows, N, level, opts,
                        row_sizes, col_sizes, self.stats_,
                        sym_block=(level == 1 and m0 > 0), device=device)
                self.precs.append(prec)
                level += 1
            if opts.dtype == "float32":
                want = np.complex64 if np.iscomplexobj(A.data) \
                    else np.float32
                self.precs = [p.astype(want) for p in self.precs]
            # factor the dense tail if present (ref factor.hpp:1284-1296); a
            # complex-symmetric tail is not Hermitian and takes the QRCP
            last = self.precs[-1]
            if last.dense_matrix is not None:
                symm = bool(opts.is_symm) and not (
                    np.iscomplexobj(last.dense_matrix)
                    and opts.symm_kind == 1)
                solver = make_dense_solver(symm, opts.spd,
                                           device=bool(opts.device_tail),
                                           torch_device=device)
                with span("hifir.factorize.tail"):
                    solver.factorize(last.dense_matrix, opts)
                last.dense_solver = solver
        hif_info(opts, "input nnz(A)=%d, nnz(precs)=%d, ratio=%g, levels=%d, "
                       "time=%gs", A.nnz, self.nnz(),
                 self.nnz() / max(A.nnz, 1), self.levels(), whole.seconds)
        if verbose_enabled("pre_time", int(opts.verbose)):
            _report_phases(opts, before, whole.seconds)
        return self

    def factorize_raw(self, n: int, indptr, indices, vals,
                      params: Optional[Options] = None, m0: int = 0,
                      device="cuda") -> "HIF":
        """POD-pointer style factorize (ref builder.hpp:386-399): accepts
        {0,1}-based CSR arrays of any integer/float width."""
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        if n and indptr[0] == 1:  # 1-based input normalization
            indptr = indptr - 1
            indices = indices - 1
        elif n and indptr[0] != 0:
            hif_error("only {0,1}-based compressed matrices are supported")
        return self.factorize(CSR(n, n, indptr, indices, np.asarray(vals)),
                              params, m0, device)

    # -- host applications (ref builder.hpp:410-556) -------------------------
    def solve(self, b: np.ndarray, trans: bool = False, r: int = 0
              ) -> np.ndarray:
        """x = M^{-1} b on the host (``trans``: M^{-H} b); ``r`` > 0
        truncates the dense tail's rank.  ``nsp`` (``nsp_tran``) filters
        the result (ref builder.hpp:410-424)."""
        if self.empty():
            hif_error("the preconditioner is empty")
        x = prec_solve_np(self.precs, np.asarray(b), r, trans=trans)
        nsp = self.nsp_tran if trans else self.nsp
        return x if nsp is None else nsp.filter(x)

    def solve_mrhs(self, B: np.ndarray, r: int = 0, trans: bool = False
                   ) -> np.ndarray:
        """X = M^{-1} B for an (n, k) block, all columns in one multilevel
        sweep (ref ``prec_solve_mrhs``, prec_solve.hpp:428); no null-space
        filter, as in the reference."""
        if self.empty():
            hif_error("the preconditioner is empty")
        if self.nsp is not None:
            hif_error("multiple RHS does not support null-space filters")
        B = np.asarray(B)
        if B.ndim != 2:
            hif_error("solve_mrhs expects an (n, k) right-hand-side block")
        return prec_solve_np(self.precs, B, r, trans=trans)

    def hifir(self, A, b: np.ndarray, N: int,
              betas: Optional[Tuple[float, float]] = None,
              trans: bool = False, r: int = 0, boost: bool = False):
        """M^{-1} with N steps of iterative refinement on the host (ref
        builder.hpp:459-505).  With ``betas`` returns ``(x, iters, flag)``,
        otherwise x; ``boost`` accumulates in long double (the reference's
        HIF_HIGH_PRECISION_SOLVE)."""
        x, iters, flag = iter_refine(self, A, b, N, betas, trans, r,
                                     boost=boost)
        return x if betas is None else (x, iters, flag)

    def mmultiply(self, x: np.ndarray, trans: bool = False, r: int = 0
                  ) -> np.ndarray:
        """y = M x (``trans``: M^H x) on the host (ref builder.hpp:540-556,
        ``prec_prod``)."""
        if self.empty():
            hif_error("the preconditioner is empty")
        if trans:
            return prec_prod_tran_np(self.precs, np.asarray(x), r)
        return prec_prod_np(self.precs, np.asarray(x), r)

    # -- device export ------------------------------------------------------
    def to_device(self, dtype=None, device="cuda", dense_inv="auto",
                  tail_on_device=False) -> DevicePrec:
        """Pack onto ``device`` for the batched M-solve; ``dtype`` is
        np.float32, np.float64, np.complex64, np.complex128 or None (the
        host's own: complex128 for a complex factorization).
        ``tail_on_device`` factorizes the dense tail again on ``device``
        with K8 instead of packing the host's factors."""
        return DevicePrec.from_host(self.precs, dtype=dtype, device=device,
                                    dense_inv=dense_inv,
                                    tail_on_device=tail_on_device)
