#!/usr/bin/env python3
"""K2 alone on the benchmark's level schedules: microseconds a pass and a
level, by width and by launch shape.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/probe_k2_tile.py [--cells p2d1m,p3d64] [--sweep] [--out DIR]

It factorizes each configuration's matrix as the benchmark does
(``hifbench/configs``, the harness's own generator and options), packs it
``auto`` in float32 (with ``--sweep`` in float64 too, the gmres cell's
dtype), and lists every level schedule with its shape: slots, K, levels,
where K2 keeps the slot vector, the team width ``tps`` and the passes of
the 1024-thread block a solve takes (a level costs ``ceil(slots / (1024 /
tps))`` passes).  It then times K2 alone (CUDA events, back-to-back
launches after a warm-up) on each schedule at 1, 8, 64 and 128 right-hand
sides (float64: at 1) in the shape ``trsv.trsv_tile`` picks and, where x
is global, in the column form forced; ``--sweep`` times every (columns,
CTAs) shape of SHAPES instead, and at one column every split of SPLITS.
Each forced shape is checked bit for bit against the column form.  A
pass's and a level's microseconds are the launch's time over its passes
and over its levels.  It writes ``probe_k2_tile.json`` under ``--out``
(default ``build``).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from probe_util import power_line, timed  # noqa: E402

CONFIGS = {"p2d1m": "poisson2d-1m", "p3d64": "poisson3d-64"}
# the widths timed in each dtype of a pack
WIDTHS = {"float32": (1, 8, 64, 128), "float64": (1,)}
# (columns, CTAs) a tile of the sweep: the column form, then tiles of 2, 4
# and 8 columns on clusters of 1 to 8 CTAs
SHAPES = ((1, 1),) + tuple((t, c) for t in (2, 4, 8) for c in (1, 2, 4, 8))
# the sweep at one column: the column form, then the split over 2 to 8 CTAs
SPLITS = ((1, 1), (1, 2), (1, 4), (1, 8))


def factorize(cell: str):
    import hifir_tpu_torch as ht
    from hifbench import problems
    from hifir_tpu_torch.ds.csr import CSR

    with open(os.path.join(ROOT, "hifbench", "configs",
                           CONFIGS[cell] + ".json")) as f:
        config = json.load(f)
    A = problems.make(config)
    t0 = time.perf_counter()
    P = ht.HIF().factorize(CSR.from_scipy(A), ht.Options(**config["options"]),
                           device="cuda")
    return P, time.perf_counter() - t0


def probe(S, cell, dname, li, name, es, gen, args) -> dict:
    """One schedule's row: its shape, then its times at each width."""
    from hifir_tpu_torch.ops import trsv

    nslots, K = S.nslots, S.K
    row = dict(dtype=dname, level=li, factor=name, n=S.n, slots=nslots,
               K=K, levels=S.nlevels, tps=trsv.trsv_team(K),
               x=trsv.trsv_shape(nslots, es),
               passes=int(S.level_passes.sum()))
    widths = WIDTHS[dname]
    B = torch.randn((S.n, max(widths)), generator=gen, device="cuda",
                    dtype=getattr(torch, dname))
    for w in widths:
        Bw = B[:, :w].contiguous()
        ms = timed(lambda: trsv.trsv_apply_cuda(S, Bw), args.reps)
        row[f"ms_{w}"] = ms
        row[f"us_pass_{w}"] = ms * 1e3 / row["passes"]
        row[f"us_level_{w}"] = ms * 1e3 / row["levels"]
        row[f"shape_{w}"] = trsv.trsv_tile(nslots, S.level_passes, es, w)
        if row["x"] != "global":
            continue
        ref = trsv._trsv_launch(S, Bw, 1)
        shapes = (SPLITS if w == 1 else SHAPES) if args.sweep else ((1, 1),)
        for t, c in shapes:
            run = lambda t=t, c=c: trsv._trsv_launch(S, Bw, t, c)
            ms = timed(run, args.reps)
            row[f"t{t}c{c}_us_pass_{w}"] = ms * 1e3 / row["passes"]
            row[f"t{t}c{c}_us_level_{w}"] = ms * 1e3 / row["levels"]
            same = torch.equal(run(), ref)
            row[f"bit_equal_t{t}c{c}_{w}"] = same
            if not same:
                print(f"FAIL {cell} {dname} {li}{name} nrhs {w}: {t} x {c} "
                      "CTAs differs from the column form", flush=True)
    print(f"{cell} {dname} level {li} {name}: slots {nslots} K {K} levels "
          f"{S.nlevels} tps {row['tps']} x {row['x']} passes "
          f"{row['passes']}: "
          + ", ".join(f"{w} RHS {row[f'ms_{w}']:.3f} ms "
                      f"({row[f'us_pass_{w}']:.3f} us a pass, "
                      f"{row[f'us_level_{w}']:.3f} a level"
                      + "".join(f", {t}x{c} "
                                f"{row[f't{t}c{c}_us_level_{w}']:.3f}"
                                for t, c in dict.fromkeys(SHAPES + SPLITS)
                                if f"t{t}c{c}_us_level_{w}" in row)
                      + ")" for w in widths), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="p2d1m,p3d64")
    ap.add_argument("--out", default="build")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sweep", action="store_true",
                    help="time every tile shape of SHAPES and every split "
                    "of SPLITS, in float32 and float64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k2_tile: no CUDA device", file=sys.stderr)
        return 2
    from hifir_tpu_torch.ops import trsv

    out = dict(smi=power_line(), torch=torch.__version__,
               cuda=torch.version.cuda, cells={})
    print(out["smi"], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(19)
    dtypes = tuple(WIDTHS) if args.sweep else ("float32",)
    for cell in args.cells.split(","):
        P, fact_s = factorize(cell)
        rows = []
        out["cells"][cell] = dict(factorize_s=fact_s, schedules=rows)
        for dname in dtypes:
            dt = getattr(torch, dname)
            es = dt.itemsize
            dp = P.to_device(dtype=np.dtype(dname), device="cuda",
                             dense_inv="auto")
            for li, lv in enumerate(dp.levels):
                for name, S in (("L", lv.L), ("U", lv.U)):
                    if not isinstance(S, trsv.TrsvSchedule) or not S.nchunks:
                        continue
                    rows.append(probe(S, cell, dname, li, name, es, gen,
                                      args))
            del dp
            torch.cuda.empty_cache()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "probe_k2_tile.json"), "w") as f:
        json.dump(out, f, indent=1)
    bad = [r for c in out["cells"].values() for r in c["schedules"]
           if any(k.startswith("bit_equal") and not v for k, v in r.items())]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
