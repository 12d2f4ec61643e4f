#!/usr/bin/env python3
"""The peer sweep (``csrc/kernels.cu:chunk_peer``) on the card(s), alone.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/probe_peer.py [--nx 512] [--f32] [--chunk] [--out DIR]

It builds the kernels (each ``chunk_sweep_kernel`` instance's registers and
spills from ``-Xptxas -v``), factorizes poisson2d(nx) on the host and
builds its ``DistPrec`` (chunk 1024, eight ranks, halo form) on each
layout the machine offers: eight ranks on one card (the one-group sweep),
two groups of four on one card (``"cuda:0"`` and ``"cuda"``: the peer
sweep, two clusters of one launch) and, with two cards or more, one group
a card over 4 (or 2) cards.  On each it holds level 0's L by the kernel
and its first halo factor against the plain version (1e-12 f64, 1e-5
f32), then solves against the
host (1e-12 / 1e-4) with the launches counted and times the solve by CUDA
events (3 calls after a warm-up).  ``--chunk`` also times the two-group
solve in the ``"chunk"`` form (K10a a chunk, one call: ~4 s), ``--f32``
adds float32, ``--cards-only`` skips the one-card layouts and
``--multicard`` then runs ``chip_smoke.py``'s multi-card legs
(``multicard_phase``).  Prints one line a result and, with ``--out``,
``DIR/probe_peer.json``.
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

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nx", type=int, default=cs.DIST_NX)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--chunk", action="store_true")
    ap.add_argument("--cards-only", action="store_true",
                    help="skip the one-card layouts")
    ap.add_argument("--multicard", action="store_true",
                    help="then chip_smoke.py's multi-card legs")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_peer: no CUDA device", file=sys.stderr)
        return 2

    import hifir_tpu_torch as ht
    from hifir_tpu_torch.kernels.build import load_kernels
    from hifir_tpu_torch.models.problems import poisson2d
    from hifir_tpu_torch.native.build import load_native
    from hifir_tpu_torch.parallel import DistPrec, make_mesh
    from hifir_tpu_torch.parallel.trsv_halo import HaloOp

    smi = cs.power_line()
    count = torch.cuda.device_count()
    out = dict(nvidia_smi=smi, cards=count)
    t0 = time.perf_counter()
    kl = load_kernels()
    load_native()
    sweeps = {k: v for k, v in cs.ptxas_report(kl.ptxas_log).items()
              if "chunk_sweep_kernel" in k}
    out.update(build_seconds=time.perf_counter() - t0, ptxas=sweeps)
    cs.log(f"build {out['build_seconds']:.1f} s [{smi}]")
    for k, v in sweeps.items():
        cs.log(f"  {k}: {v}")

    A = poisson2d(args.nx)
    t0 = time.perf_counter()
    P = ht.HIF().factorize(A, ht.Options(verbose=0), device="cuda")
    b = np.random.default_rng(6).standard_normal(A.nrows)
    xh = P.solve(b)
    xmax = np.abs(xh).max()
    cs.log(f"poisson2d({args.nx}) factorize + host solve "
           f"{time.perf_counter() - t0:.1f} s; levels "
           f"{[(p.m, p.n) for p in P.precs]}")

    layouts = [] if args.cards_only else [
        ("one card, one group", ["cuda"] * 8, 1),
        ("one card, two groups", ["cuda:0"] * 4 + ["cuda"] * 4, 1)]
    if count >= 2:
        k = 4 if count >= 4 else 2
        layouts.append((f"{k} cards", [f"cuda:{i}" for i in range(k)
                                       for _ in range(8 // k)], k))
        out["peer_access"] = [[i == j or torch.cuda.can_device_access_peer(
            i, j) for j in range(count)] for i in range(count)]
        cs.log(f"peer access {out['peer_access']}")
    dtypes = ((np.float64, 1e-12, 1e-12),) + (
        ((np.float32, 1e-4, 1e-5),) if args.f32 else ())
    rng = np.random.default_rng(13)
    launches, rows = {}, []
    for name, devices, ncards in layouts:
        mesh = make_mesh(devices=devices)
        for npdt, tol, ktol in dtypes:
            dname = np.dtype(npdt).name
            what = f"{name} {dname}"
            dp = DistPrec.from_host(mesh, P, dtype=npdt,
                                    chunk=cs.DIST_CHUNK, max_halo_chunks=128)
            shape = cs.dist_solve_factors(dp)
            # level 0's L (all_gather form) and the first halo factor
            op = dp.levels[0].L_op
            ops = [op] + [o for lv in dp.levels for o in (lv.L_op, lv.U_op)
                          if isinstance(o, HaloOp) and o.nchunks][:1]
            pair = cs.peer_pair if op.plan.form == "peer" else cs.sweep_pair
            t0 = time.perf_counter()
            kerr = 0.0
            for o in ops:
                Y, Yp = pair(torch, rng, o, dp.dtype)[2:]
                kerr = max(kerr, cs.rel_diff(Y, Yp))
            first = time.perf_counter() - t0
            cs.gate(kerr <= ktol, f"{what}: kernel vs plain {kerr:.3e} "
                    f"({len(ops)} factors)")
            x = cs.dist_count(torch, launches, what,
                              lambda: dp.solve(b)).double().cpu().numpy()
            err = float(np.abs(x - xh).max() / xmax)
            cs.gate(err <= tol, f"{what}: vs host {err:.3e}")
            per = launches[what]
            if op.plan.form == "peer":
                cs.peer_gates(per, shape, ncards, what)
            else:
                cs.sweep_gates(per, shape, what)
            ms = cs.timed(torch, lambda: dp.solve(b), 3)
            row = dict(layout=name, dtype=dname, forms=shape["forms"],
                       chunks_per_solve=shape["chunks_per_solve"],
                       kernel_vs_plain=kerr, first_pair_seconds=first,
                       err_vs_host=err, solve_ms=ms,
                       us_per_step=ms * 1e3 / shape["chunks_per_solve"],
                       launches=per)
            rows.append(row)
            cs.log(f"{what}: forms {shape['forms']}; kernel vs plain "
                   f"{kerr:.3e}; rel err vs host {err:.3e}; solve {ms:.4f} "
                   f"ms ({row['us_per_step']:.3f} us a chunk step, CUDA "
                   f"events); launches {per} [{smi}]")
            if args.chunk and ncards == 1 and name.endswith("groups") \
                    and npdt == np.float64:
                dpc = DistPrec.from_host(mesh, P, chunk=cs.DIST_CHUNK,
                                         max_halo_chunks=128, form="chunk")
                ms = cs.timed(torch, lambda: dpc.solve(b), 1)
                rows.append(dict(layout=name, dtype=dname, forms=["chunk"],
                                 solve_ms=ms))
                cs.log(f"{what}, chunk form: solve {ms:.4f} ms (CUDA "
                       f"events) [{smi}]")
    out["rows"] = rows
    if args.multicard:
        from hifir_tpu_torch.models.problems import convdiff2d

        Ac = convdiff2d(128)
        base = dict(cs.FIXTURE_OPTS, use_native=0)
        ctx = dict(P=P, A=A, b=b, xh=xh, single=P.to_device(device="cuda"),
                   Ac=Ac, Ph=ht.HIF().factorize(Ac, ht.Options(**base),
                                                device="cuda"), base=base)
        out["multicard"], out["multicard_launches"] = cs.multicard_phase(
            torch, np.random.default_rng(16), smi, ctx)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "probe_peer.json"), "w") as f:
            json.dump(out, f, indent=1)
    print(smi)
    print(json.dumps({"ok": True, "rows": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
