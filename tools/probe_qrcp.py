#!/usr/bin/env python3
"""K8 (the device QRCP, ``qrcp_kernel``) alone on the card: build, check, time.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/probe_qrcp.py [--quick] [--out DIR]

It builds the CUDA kernels, prints K8's registers and spills from nvcc's
``-Xptxas -v`` report, launches the kernel once on an 8x8 matrix under a
watchdog (a launch that has not finished within 30 s ends the process,
which frees the card), then, for seeded Gaussian matrices of several n in
float64 and float32, holds the kernel against its plain version on the
card (pivots, sign-normalised Q and R, |QR - AP|) and times it by CUDA
events, at the default grid and at several columns a CTA (a grid that
cannot be co-resident is recorded as refused), then factorizes once each
of LARGE, the sizes whose x, map and inverse leave shared memory (the
"global_x" layout; n = 19313 is the first such f32 n on 132 SMs), held to
|A[:, piv] - Q R| / |A| and |Q^T Q - I| within n eps (TF32 off) and piv a
permutation led by the column of largest norm.  ``--quick`` stops after
the checks at n <= 360; ``--large`` runs only LARGE; ``--out DIR`` writes
everything to ``DIR/probe_qrcp.json``.  The numbers are what PERF.md's K8
design notes quote.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from card_common import first_diff, qr_dist  # noqa: E402
from hifir_tpu_torch.kernels.build import load_kernels  # noqa: E402
from hifir_tpu_torch.small_scale import qrcp_device as qd  # noqa: E402
from probe_util import Timer, power_line  # noqa: E402

SIZES = (8, 33, 203, 360, 736, 1200, 1400, 2000)
SWEEP = (203, 360, 736, 2000)
COLS = (0, 1, 2, 4, 8, 16, 32)
LARGE = ((19313, torch.float32),)


def watchdog_first_launch():
    A = torch.as_tensor(np.random.default_rng(0).standard_normal((8, 8)),
                        device="cuda")
    qd.qrcp_device_cuda(A)
    t0 = time.perf_counter()
    while not torch.cuda.current_stream().query():
        if time.perf_counter() - t0 > 30:
            print("probe_qrcp: the first launch did not finish in 30 s",
                  file=sys.stderr, flush=True)
            os._exit(3)
        time.sleep(0.01)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def factorize_large(n, dt, rng, smi) -> dict:
    """One factorization at n in dt on a seeded Gaussian A made on the card,
    timed by CUDA events, and its gates (module docstring)."""
    plan = qd.qrcp_plan(n, dt)
    g = torch.Generator(device="cuda")
    g.manual_seed(int(rng.integers(2**62)))
    A = torch.randn((n, n), generator=g, dtype=dt, device="cuda")
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    Q, R, piv = qd.qrcp_device_cuda(A)
    e.record()
    torch.cuda.synchronize()
    ms = s.elapsed_time(e)
    torch.backends.cuda.matmul.allow_tf32 = False
    res = float((A[:, piv] - Q @ R).abs().max() / A.abs().max())
    Q = Q.T @ Q
    Q.diagonal().sub_(1.0)
    orth = float(Q.abs().max())
    p = piv.cpu().numpy()
    perm = bool(np.array_equal(np.sort(p), np.arange(n)))
    first = int(torch.argmax((A.double() ** 2).sum(0)))
    tol = n * float(torch.finfo(dt).eps)
    dn = str(dt).removeprefix("torch.")
    ok = bool(res <= tol and orth <= tol and perm and p[0] == first)
    print(f"n={n} {dn}: {plan['layout']} {plan['grid']} CTAs of "
          f"{plan['cols']}; {ms:.1f} ms ({ms * 1e3 / n:.2f} us a step); "
          f"|QR-AP|/|A| {res:.2e}, |Q^T Q - I| {orth:.2e} (tol {tol:.1e}); "
          f"piv a permutation {perm}, piv[0] {p[0]} (largest norm {first})"
          f": {'ok' if ok else 'FAILED'} [{smi}]", flush=True)
    del A, Q, R
    torch.cuda.empty_cache()
    return dict(n=n, dtype=dn, plan=plan, ms=ms, us_per_step=ms * 1e3 / n,
                residual=res, orthogonality=orth, permutation=perm,
                first=int(p[0]), largest_norm=first, tol=tol, ok=ok)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_qrcp: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    quick = args.quick
    smi = power_line()
    t0 = time.perf_counter()
    kl = load_kernels()
    out = dict(smi=smi, build_seconds=time.perf_counter() - t0)
    lines = kl.ptxas_log.splitlines()
    rep = []
    for i, ln in enumerate(lines):
        if "qrcp_kernel" in ln and "Compiling entry" in ln:
            rep += lines[i:i + 4]
    out["ptxas"] = rep
    print("\n".join(rep), flush=True)
    out["first_launch_ms"] = watchdog_first_launch()
    print(f"first launch done in {out['first_launch_ms']:.1f} ms [{smi}]",
          flush=True)
    T = Timer()
    rng = np.random.default_rng(7)
    checks, times = [], []
    for n in SIZES:
        if (quick and n > 360) or args.large:
            break
        D = rng.standard_normal((n, n))
        for dt in (torch.float64, torch.float32):
            dn = str(dt).removeprefix("torch.")
            A = torch.as_tensor(D, dtype=dt, device="cuda")
            plan = qd.qrcp_plan(n, dt)
            F = qd.qrcp_device_cuda(A)
            torch.cuda.synchronize()
            Fp = qd.qrcp_device_plain(A)
            pk, pp = F[2].cpu().numpy(), Fp[2].cpu().numpy()
            s = first_diff(pk, pp, n)
            dq, dr, _ = qr_dist(F, Fp, s)
            A64 = A.double()
            res = float((F[0].double() @ F[1].double() - A64[:, F[2]])
                        .abs().max() / A64.abs().max())
            ms = T.ms(lambda: qd.qrcp_device_cuda(A), iters=5)
            rec = dict(n=n, dtype=dn, plan=plan, pivots_equal_to=s, q=dq,
                       r=dr, residual=res, ms=ms, us_per_step=ms * 1e3 / n)
            checks.append(rec)
            print(f"n={n:5d} {dn}: {plan['layout']:6s} {plan['grid']:3d} "
                  f"CTAs of {plan['cols']:2d}; pivots equal on {s}; Q {dq:.2e}"
                  f" R {dr:.2e} |QR-AP| {res:.2e}; {ms:.4f} ms "
                  f"({ms * 1e3 / n:.2f} us a step) [{smi}]", flush=True)
    if not quick and not args.large:
        for n in SWEEP:
            A = torch.as_tensor(rng.standard_normal((n, n)), device="cuda")
            for cols in COLS:
                try:
                    plan = qd.qrcp_plan(n, A.dtype, cols_per_cta=cols)
                except RuntimeError as err:
                    times.append(dict(n=n, cols=cols, refused=str(err)))
                    print(f"n={n} cols={cols}: refused ({err})", flush=True)
                    continue
                ms = T.ms(lambda: qd.qrcp_device_cuda(A, cols), iters=5)
                times.append(dict(n=n, cols=cols, plan=plan, ms=ms,
                                  us_per_step=ms * 1e3 / n))
                print(f"n={n} f64 cols={cols} ({plan['layout']}, "
                      f"{plan['grid']} CTAs): {ms:.4f} ms, "
                      f"{ms * 1e3 / n:.2f} us a step [{smi}]", flush=True)
    large = [] if quick else [factorize_large(n, dt, rng, smi)
                              for n, dt in LARGE]
    out.update(checks=checks, sweep=times, large=large)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "probe_qrcp.json"), "w") as f:
            json.dump(out, f, indent=1)
    return 0 if all(x["ok"] for x in large) else 1


if __name__ == "__main__":
    sys.exit(main())
