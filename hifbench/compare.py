"""The comparisons that decide ``correct``: each number is a gap between
what the program produced and what the plain reference
(:mod:`hifbench.reference`) works out in float64 from the same inputs,
judged against the cell's limit (``cells/<cell>.json``; PERF.md gives the
readings each limit was set from)."""

from __future__ import annotations

import numpy as np

from . import reference

__all__ = ["gap", "fact_gap", "structure", "factorization", "verdict"]


def gap(x: np.ndarray, ref: np.ndarray) -> float:
    """Max |x - ref| over max |ref|, the worst column of a block."""
    x = x.reshape(x.shape[0], -1)
    ref = ref.reshape(ref.shape[0], -1)
    return float((np.abs(x - ref).max(axis=0)
                  / np.maximum(np.abs(ref).max(axis=0), 1e-300)).max())


def fact_gap(P: "reference.Prec", A, seed: int) -> float:
    """The factorize checked by itself: ||M x - A x|| / ||A x|| for a
    seeded normal x, M applied from the host factors.  A sound
    factorization reads its dropping's size; a wrong permutation, scaling
    or block reads O(1)."""
    x = np.random.default_rng([seed, 7]).standard_normal(A.shape[0])
    ax = A @ x
    return float(np.linalg.norm(reference.mprod(P, x) - ax)
                 / np.linalg.norm(ax))


def structure(levels, tail, A) -> dict:
    """The factorization's shape: its levels, the dense tail's rows and
    its fill nnz(M) / nnz(A) (every level's L, U, E and F entries and its
    diagonal, and the dense tail's entries)."""
    nt = 0 if tail is None else int(tail.shape[0])
    nnz = sum(int(lv[k].nnz) for lv in levels for k in "LUEF") \
        + sum(int(lv["m"]) for lv in levels) + nt * nt
    return {"levels": len(levels), "tail": nt, "fill": nnz / int(A.nnz)}


def factorization(levels, tail, A, stated: dict, seed: int,
                  P=None) -> dict:
    """The factorize checked by itself, whatever the traffic: ``fact_gap``,
    and for each shape the configuration states (``stated``: ``tail``,
    ``fill``, as :func:`structure` reads them) its relative gap,
    ``<key>_gap``.  A factorize that drops more keeps ``fact_gap`` near
    its dropping's size but fills less and may end on a smaller tail.
    ``P``: the float64 :class:`hifbench.reference.Prec` of these levels,
    if made already."""
    got = structure(levels, tail, A)
    P = P or reference.Prec(levels, tail)
    out = {"fact_gap": fact_gap(P, A, seed)}
    for k, want in stated.items():
        out[f"{k}_gap"] = abs(got[k] - want) / max(abs(want), 1)
    return out


def verdict(values: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every number at or under its limit; the
    checks as {name: {"value", "limit"}}."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    ok = all(np.isfinite(v) and v <= limits[k] for k, v in values.items())
    return bool(ok), checks
