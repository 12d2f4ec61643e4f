"""Logging and verbose control.

The port's copy of ``hifir_tpu/utils/log.py``: the reference printf/ANSI
logging macros (``src/hif/utils/log.hpp:67-183``) and the verbose bitmask
helpers (``Options.h:46-55``).  Errors raise :class:`HifError` (the analogue of
the reference ``HIF_THROW`` mode, ``utils/log.hpp:173-183``) instead of
aborting the process.
"""

from __future__ import annotations

import sys

from ..options import (
    VERBOSE_FAC,
    VERBOSE_INFO,
    VERBOSE_INFO2,
    VERBOSE_MEM,
    VERBOSE_NONE,
    VERBOSE_PRE,
    VERBOSE_PRE_TIME,
    VERBOSE_WARN,
)

__all__ = [
    "HifError",
    "hif_info",
    "hif_warning",
    "hif_error",
    "hif_assert",
    "verbose_enabled",
    "enable_warnings",
]


class HifError(RuntimeError):
    """Fatal error raised by the framework (ref ``hif_error``)."""


_LEVELS = {
    "warn": VERBOSE_WARN,
    "info": VERBOSE_INFO,
    "pre": VERBOSE_PRE,
    "fac": VERBOSE_FAC,
    "pre_time": VERBOSE_PRE_TIME,
    "mem": VERBOSE_MEM,
    "info2": VERBOSE_INFO2,
}


def verbose_enabled(tag: str, verbose: int) -> bool:
    """Check a verbose tag against a bitmask (ref ``hif_verbose`` macro)."""
    if verbose == VERBOSE_NONE or verbose < 0:
        return False
    mask = _LEVELS[tag]
    # INFO2 implies INFO in the reference
    if tag == "info" and (verbose & VERBOSE_INFO2):
        return True
    return bool(verbose & mask)


def hif_info(opts_or_verbose, msg: str, *args, tag: str = "info") -> None:
    """Print an info-level message when enabled by the verbose mask."""
    verbose = getattr(opts_or_verbose, "verbose", opts_or_verbose)
    if verbose_enabled(tag, int(verbose)):
        print(msg % args if args else msg, file=sys.stdout, flush=True)


_warnings_enabled = True


def enable_warnings(on: bool) -> None:
    """Global warning toggle (ref ``lhfEnableWarning``/``lhfDisableWarning``,
    libhifir.h:245-250)."""
    global _warnings_enabled
    _warnings_enabled = bool(on)


def hif_warning(msg: str, *args) -> None:
    """Print a warning (shown unless disabled via :func:`enable_warnings`;
    ref ``hif_warning``)."""
    if not _warnings_enabled:
        return
    print("\033[33mWARNING!\033[0m " + (msg % args if args else msg),
          file=sys.stderr, flush=True)


def hif_error(msg: str, *args) -> None:
    """Raise a fatal :class:`HifError` (ref ``hif_error``)."""
    raise HifError(msg % args if args else msg)


def hif_assert(cond: bool, msg: str, *args) -> None:
    """Internal consistency check (ref ``hif_assert``, only in debug builds)."""
    if not cond:
        raise HifError("assertion failed: " + (msg % args if args else msg))
