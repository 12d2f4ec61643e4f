#!/usr/bin/env python3
"""K2 alone on the benchmark's factors under the reference schedule, the
card schedule and forced split caps: the readings that fit
``ops/trsv.py``'s T_LEVEL and T_ROUND.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/probe_k2_schedule.py [--cells stk256,p3d64,p2d1m]
                                       [--pairs TL:TR,...] [--no-caps]
                                       [--out DIR] [--reps N]
    python3 tools/probe_k2_schedule.py --digests ROOT [--out DIR]

It factorizes each configuration's matrix as the benchmark does
(``hifbench/configs``, the harness's generator and options) and takes
every factor that K2 solves in the cells (a level above 8 x 2048 rows),
at the dtype and width of its cells: stk256 f64 at 32 columns, p3d64 f32
at 128 and f64 at 1, p2d1m f32 at 64.  For each factor it builds the
reference schedule (``build_trsv_schedule``, chunk and cap "auto"), the
card schedule (``build_trsv_schedule_card``), card schedules under other
``--pairs`` of the cost model's constants and, unless ``--no-caps``,
card layouts whose every level is split at one forced cap (4, 8, ...
below the widest row) or not at all, and prints for each the graph's depth, the effective levels, the
rounds (K2's passes of its block over a level's slots times the 4-entry
lines a lane takes a pass), where x lives, the form ``trsv_tile`` picks,
and K2's milliseconds (CUDA events over back-to-back launches after a
warm-up) in the column form and, where x is global and there are several
columns, in the tile form, with microseconds a level.  Each schedule's X
is held to the reference schedule's (1e-4 f32, 1e-10 f64, relative to
the largest entry).  It writes ``probe_k2_schedule.json`` under
``--out`` (default ``build``).

``--digests ROOT`` prints (and writes as ``k2_uniform_digests.json``) the
SHA-256 digests of K2's output on the uniform reference schedules of
``tests/test_torch_k2_card.py:uniform_digests``, with the package of the
checkout at ROOT: the test's data is the digests of an earlier K2.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CELLS = {"stk256": ("stokes2d-mac-256", (("float64", 32),)),
         "p3d64": ("poisson3d-64", (("float32", 128), ("float64", 1))),
         "p2d1m": ("poisson2d-1m", (("float32", 64),))}
SCAN_ABOVE = 8 * 2048


def digests(root: str, out: str) -> int:
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location(
        "k2_card", os.path.join(ROOT, "tests", "test_torch_k2_card.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = mod.uniform_digests()
    print(json.dumps(got, indent=1), flush=True)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "k2_uniform_digests.json"), "w") as f:
        json.dump(got, f, indent=1)
    return 0


def fill(trsv, np, S):
    """Each level's slots over its block's slots a pass (1024 / tps)."""
    return np.diff(S.level_slots) / (trsv.TRSV_THREADS
                                     // trsv._teams(S.level_K))


def variants(trsv, np, T, lower, ndt, pairs, caps):
    """``(name, schedule)`` of the factor: the reference, the card's, the
    card's under each other ``(T_LEVEL, T_ROUND)`` of ``pairs``, then, with
    ``caps``, one forced cap for every level (4, 8, ... below the widest
    row), then none."""
    yield "ref", trsv.build_trsv_schedule(T, lower=lower, chunk="auto",
                                          dtype=ndt, k_cap="auto",
                                          device="cuda")
    yield "card", trsv.build_trsv_schedule_card(T, lower, dtype=ndt,
                                                device="cuda")
    dev = trsv.resolve_device("cuda")
    for tl, tr in pairs:
        yield f"card{tl}:{tr}", trsv._card_schedule(
            T, lower, ndt, dev,
            lambda d, lev, tl=tl, tr=tr: trsv._level_caps(d, lev, tl, tr))
    if not caps:
        return
    kmax = int(np.diff(T.indptr).max())
    cap = 4
    while cap < kmax:
        yield f"cap{cap}", trsv._card_schedule(
            T, lower, ndt, dev,
            lambda d, lev, c=cap: np.full(int(lev.max()) + 1, c))
        cap *= 2
    yield "unsplit", trsv._card_schedule(
        T, lower, ndt, dev,
        lambda d, lev: np.full(int(lev.max()) + 1, trsv._UNSPLIT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="stk256,p3d64,p2d1m")
    ap.add_argument("--out", default="build")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--digests", metavar="ROOT")
    ap.add_argument("--pairs", default="",
                    help="T_LEVEL:T_ROUND,... to build card schedules with")
    ap.add_argument("--no-caps", action="store_true",
                    help="skip the forced caps")
    args = ap.parse_args()
    pairs = [tuple(map(float, p.split(":")))
             for p in args.pairs.split(",") if p]
    if args.digests:
        return digests(args.digests, args.out)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_k2_schedule: no CUDA device", file=sys.stderr)
        return 2
    import hifir_tpu_torch as ht
    from hifbench import problems
    from hifir_tpu_torch.ds.csr import CSR
    from hifir_tpu_torch.ops import trsv
    from probe_util import power_line, timed

    out = dict(smi=power_line(), torch=torch.__version__,
               cuda=torch.version.cuda, constants=dict(
                   T_LEVEL=trsv.T_LEVEL, T_ROUND=trsv.T_ROUND), rows=[])
    print(out["smi"], flush=True)
    bad = 0
    for cell in args.cells.split(","):
        name, widths = CELLS[cell]
        with open(os.path.join(ROOT, "hifbench", "configs",
                               name + ".json")) as f:
            config = json.load(f)
        A = problems.make(config)
        P = ht.HIF().factorize(CSR.from_scipy(A),
                               ht.Options(**config["options"]),
                               device="cuda")
        for li, prec in enumerate(P.precs):
            if prec.m <= SCAN_ABOVE:
                continue
            for fname, T, lower in (("L", prec.L_B, True),
                                    ("U", prec.U_B, False)):
                depth = int(trsv._compute_levels(T.nrows, T.indptr,
                                                 T.indices, lower).max()) + 1
                for dname, nrhs in widths:
                    ndt = np.dtype(dname)
                    es = ndt.itemsize
                    gen = torch.Generator(device="cuda").manual_seed(22)
                    B = torch.randn((T.nrows, nrhs), generator=gen,
                                    device="cuda",
                                    dtype=getattr(torch, dname))
                    ref = None
                    for vname, S in variants(trsv, np, T, lower, ndt,
                                             pairs, not args.no_caps):
                        t0 = time.perf_counter()
                        rounds = int(trsv._rounds(np.diff(S.level_slots),
                                                  S.level_K).sum())
                        row = dict(
                            cell=cell, level=li, factor=fname, dtype=dname,
                            nrhs=nrhs, schedule=vname, n=S.n, depth=depth,
                            levels=S.nlevels, rounds=rounds,
                            passes=int(S.level_passes.sum()),
                            slots=S.nslots, K=S.K,
                            fill=float(np.mean(fill(trsv, np, S))),
                            multi_pass_share=float(
                                S.level_passes[S.level_passes > 1].sum()
                                / max(S.level_passes.sum(), 1)),
                            median_level_slots=float(
                                np.median(np.diff(S.level_slots))),
                            x=trsv.trsv_shape(S.nslots, es),
                            form=list(trsv.trsv_tile(
                                S.nslots, S.level_passes, es, nrhs)))
                        col = lambda S=S: trsv._trsv_launch(S, B, 1, 1)
                        X = col()
                        if ref is None:
                            ref = X
                        gap = float((X - ref).abs().max()
                                    / ref.abs().max())
                        row["gap"] = gap
                        if gap > (1e-4 if es == 4 else 1e-10):
                            bad += 1
                            print(f"FAIL {cell} {li}{fname} {vname}: gap "
                                  f"{gap:.3e}", flush=True)
                        row["ms_column"] = timed(col, args.reps)
                        if row["x"] == "global" and nrhs > 1:
                            G, C = trsv.tile_shape(es, nrhs)
                            row["ms_tile"] = timed(
                                lambda S=S: trsv._trsv_launch(S, B, G, C),
                                args.reps)
                        chosen = ("ms_tile" if tuple(row["form"]) != (1, 1)
                                  else "ms_column")
                        row["ms"] = row[chosen]
                        row["us_level"] = 1e3 * row["ms"] / S.nlevels
                        row["probe_s"] = time.perf_counter() - t0
                        out["rows"].append(row)
                        print(f"{cell} {li}{fname} {dname}x{nrhs} "
                              f"{vname:8s} depth {depth} levels "
                              f"{S.nlevels} rounds {rounds} passes "
                              f"{row['passes']} slots {S.nslots} K {S.K} "
                              f"x {row['x']} form {row['form']} fill "
                              f"{row['fill']:.2f} multi "
                              f"{row['multi_pass_share']:.2f} median "
                              f"{row['median_level_slots']:.0f} col "
                              f"{row['ms_column']:.3f} ms"
                              + (f" tile {row['ms_tile']:.3f} ms"
                                 if "ms_tile" in row else "")
                              + f" ({row['us_level']:.3f} us a level)",
                              flush=True)
                        del S
                    del ref, B
                    torch.cuda.empty_cache()
        del P
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "probe_k2_schedule.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
