"""Control parameters for the HIF preconditioner.

The port's copy of ``hifir_tpu/options.py``: the reference HIFIR library's
28-field options struct (``src/hif/Options.h:82-163``) as a dataclass, with
the same field names, meanings and defaults, followed by the JAX package's
extensions, field for field, so that
``Options(**dataclasses.asdict(jax_options))`` builds the same options
here.  The string-keyed setter mirrors ``set_option_attr``
(``Options.h:446-541``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

__all__ = [
    "Options",
    "Params",
    "VERBOSE_NONE",
    "VERBOSE_WARN",
    "VERBOSE_INFO",
    "VERBOSE_PRE",
    "VERBOSE_FAC",
    "VERBOSE_PRE_TIME",
    "VERBOSE_MEM",
    "VERBOSE_INFO2",
    "REORDER_OFF",
    "REORDER_AUTO",
    "REORDER_AMD",
    "REORDER_RCM",
    "PIVOTING_OFF",
    "PIVOTING_ON",
    "PIVOTING_AUTO",
    "get_default_options",
    "determine_fac_pars",
]

# ---------------------------------------------------------------------------
# verbose bitmask (ref: Options.h:46-55)
# ---------------------------------------------------------------------------
VERBOSE_NONE = 0
VERBOSE_WARN = 1
VERBOSE_INFO = 2
VERBOSE_PRE = 4
VERBOSE_FAC = 8
VERBOSE_PRE_TIME = 16
VERBOSE_MEM = 32
VERBOSE_INFO2 = 64

# reorder enum (ref: Options.h:57-63)
REORDER_OFF = 0
REORDER_AUTO = 1
REORDER_AMD = 2
REORDER_RCM = 3
_REORDER_NULL = 4

# pivoting enum (ref: Options.h:65-70)
PIVOTING_OFF = 0
PIVOTING_ON = 1
PIVOTING_AUTO = 2


@dataclasses.dataclass
class Options:
    """HIF control parameters (ref ``Options.h:82-117``, defaults ``:135-163``).

    All 28 reference fields are present with identical names and defaults.
    The JAX package's extensions live at the end and default to values that
    do not change reference-parity behavior.
    """

    tau_L: float = 1e-4       # inverse-based droptol for L
    tau_U: float = 1e-4       # inverse-based droptol for U
    kappa_d: float = 3.0      # inverse-diagonal threshold
    kappa: float = 3.0        # inverse-norm threshold
    alpha_L: float = 10.0     # nnz growth factor per column of L
    alpha_U: float = 10.0     # nnz growth factor per row of U
    rho: float = 0.5          # density threshold for dense last level
    c_d: float = 10.0         # size parameter for dense last level
    c_h: float = 2.0          # size parameter for H-version
    N: int = -1               # reference size (-1 => system size)
    verbose: int = 1          # message output bitmask (1 == VERBOSE_WARN)
    rf_par: int = 1           # level-based parameter refinement on/off
    reorder: int = REORDER_AMD
    spd: int = 0              # 0 indefinite, >0 PD, <0 ND
    check: int = 1            # validate user input
    pre_scale: int = 0        # a-priori scaling: 0 off, 1 extreme, 2 iterative
    symm_pre_lvls: int = -2   # levels with symmetric preprocessing (neg => auto)
    threads: int = 0          # host threads (0 => runtime default)
    mumps_blr: int = 1        # deprecated in reference; kept for API parity
    fat_schur_1st: int = 0    # double alpha when dropping L_E/U_F on level 1
    rrqr_cond: float = 0.0    # RRQR condition threshold (0 => eps^{-2/3})
    pivot: int = PIVOTING_AUTO
    gamma: float = 1.0        # thresholded pivoting factor
    beta: float = 1e3         # scaling-safeguard ratio
    is_symm: int = 0          # Hermitian/symmetric input flag
    no_pre: int = 0           # disable preprocessing
    nzp_thres: float = 0.65   # pattern-symmetry threshold for symm pre
    dense_thres: int = 2000   # size threshold for dense Schur termination

    # --- extensions (not in the reference struct) ---------------------------
    dtype: str = "float64"    # factorization/solve precision
    use_native: int = 1       # use the native host library's Crout kernels
    dist_schur: int = 0       # the Schur complement by the ring SpGEMM
    device_tail: int = 0      # factorize the dense tail on the GPU (QRCP,
                              # small_scale/qrcp_device.py)
    symm_detect: int = 1      # auto-engage the LDL^T path on exactly
                              # symmetric real input (halves Crout scan work;
                              # the reference requires the user to set
                              # is_symm, Options.h:152)
    symm_kind: int = 0        # complex is_symm classification set by
                              # api.factorize: 1 = A == A^T (LDL^T),
                              # 2 = A == A^H (Hermitian LDL^H), 0 = unset
                              # (real input, or unclassified complex ->
                              # general path)
    dense_defer: int = 1      # cost-aware dense-switch refinement: ignore the
                              # static dense_thres floor while levels factor
                              # healthily and the c_d*N^(1/3) floor has not
                              # been reached (avoids O(nm^3) QRCP on a
                              # still-shrinking tail; 0 = exact reference
                              # semantics, ref factor.hpp:1231-1235)

    # -- introspection ------------------------------------------------------
    _REF_FIELDS = (
        "tau_L", "tau_U", "kappa_d", "kappa", "alpha_L", "alpha_U", "rho",
        "c_d", "c_h", "N", "verbose", "rf_par", "reorder", "spd", "check",
        "pre_scale", "symm_pre_lvls", "threads", "mumps_blr", "fat_schur_1st",
        "rrqr_cond", "pivot", "gamma", "beta", "is_symm", "no_pre",
        "nzp_thres", "dense_thres",
    )

    def set(self, name: str, value: Any) -> bool:
        """String-keyed setter (ref ``Options.h:446-541``).

        Returns ``True`` on *failure* (unknown name or bad value), matching the
        reference convention where a nonzero return flags an error.
        """
        if (name not in self._REF_FIELDS
                and name not in ("dtype", "use_native", "dist_schur",
                                 "device_tail", "symm_detect",
                                 "dense_defer", "symm_kind")):
            return True
        field_types = {f.name: f.type for f in dataclasses.fields(self)}
        ty = field_types[name]
        try:
            if ty == "float":
                setattr(self, name, float(value))
            elif ty == "int":
                setattr(self, name, int(value))
            else:
                setattr(self, name, str(value))
        except (TypeError, ValueError):
            return True
        return False

    def set_options(self, **kwargs: Any) -> None:
        """Bulk setter; raises on unknown keys."""
        for k, v in kwargs.items():
            if self.set(k, v):
                raise KeyError(f"unknown or invalid option {k!r}={v!r}")

    def repr_options(self) -> str:
        """Pretty printer mirroring ``opt_repr`` (ref ``Options.h:324-440``)."""
        lines = []
        for f in self._REF_FIELDS:
            lines.append(f"{f:>14} {getattr(self, f)}")
        return "\n".join(lines)

    # whitespace-stream extraction order (ref ``operator>>``, Options.h:566:
    # sequential field order WITHOUT ``pivot``)
    _STREAM_FIELDS = (
        "tau_L", "tau_U", "kappa_d", "kappa", "alpha_L", "alpha_U", "rho",
        "c_d", "c_h", "N", "verbose", "rf_par", "reorder", "spd", "check",
        "pre_scale", "symm_pre_lvls", "threads", "mumps_blr", "fat_schur_1st",
        "rrqr_cond", "gamma", "beta", "is_symm", "no_pre", "nzp_thres",
        "dense_thres",
    )

    @classmethod
    def from_stream(cls, text) -> "Options":
        """Parse 27 whitespace-separated values in the reference's stream
        order (``operator>>``, ref ``Options.h:566-575``; note the stream
        format predates ``pivot`` and does not include it).  ``text`` may be
        a string or any object with ``read()``."""
        if hasattr(text, "read"):
            text = text.read()
        toks = str(text).split()
        if len(toks) < len(cls._STREAM_FIELDS):
            raise ValueError(
                f"expected {len(cls._STREAM_FIELDS)} values, got {len(toks)}")
        opts = cls()
        field_types = {f.name: f.type for f in dataclasses.fields(opts)}
        for name, tok in zip(cls._STREAM_FIELDS, toks):
            conv = float if field_types[name] == "float" else int
            setattr(opts, name, conv(tok))
        return opts

    def to_stream(self) -> str:
        """Serialize in the ``from_stream`` order (round-trips)."""
        return " ".join(repr(getattr(self, f)) for f in self._STREAM_FIELDS)

    def clone(self) -> "Options":
        return dataclasses.replace(self)


# C-style alias (ref: Options.h typedef hif_Params)
Params = Options


def get_default_options() -> Options:
    """Mirror of ``hif_get_default_options`` (ref ``Options.h:135-163``)."""
    return Options()


def determine_fac_pars(opts: Options, level: int) -> Tuple[float, float, float, float, float, float]:
    """Level-adaptive parameter refinement.

    Returns ``(kappa_d, kappa, tau_U, tau_L, alpha_L, alpha_U)`` following the
    reference semantics (``src/hif/alg/factor.hpp:80-118``):
    with ``rf_par`` on, kappa parameters relax as ``max(2, kappa^(1/min(lvl,2)))``,
    taus tighten by ``10^{-min(lvl-1, 1)}`` and alphas double on levels <= 2.
    """
    if opts.rf_par:
        fac = min(level, 2)
        fac2 = 1.0 / min(10.0, 10.0 ** (level - 1))
        kappa_d = max(2.0, opts.kappa_d ** (1.0 / fac))
        kappa = max(2.0, opts.kappa ** (1.0 / fac))
        tau_U = opts.tau_U * fac2
        tau_L = opts.tau_L * fac2
        if level > 2:
            alpha_L = opts.alpha_L
            alpha_U = opts.alpha_U
        else:
            alpha_L = opts.alpha_L * fac
            alpha_U = opts.alpha_U * fac
    else:
        kappa_d = opts.kappa_d
        kappa = opts.kappa
        tau_U = opts.tau_U
        tau_L = opts.tau_L
        alpha_L = opts.alpha_L
        alpha_U = opts.alpha_U
    return kappa_d, kappa, tau_U, tau_L, alpha_L, alpha_U
