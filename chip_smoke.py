#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hifir_tpu_torch) on one NVIDIA GPU; check it.

Run from the root of a checkout, on a machine with a card and nvcc:

    python3 chip_smoke.py [--seed 0] [--out DIR]

Phases, in order; any failed gate raises and the script exits non-zero:

1. Toolchain: torch, CUDA, nvcc, the card's name and power limit.
2. Build the hand-written kernels (csrc/kernels.cu) with nvcc.
3. Kernel phases: each kernel (K7 BSR SpMV, K1 sliced-ELL SpMV, K2 level
   scan) against its plain PyTorch version on the card, at the main path's
   shapes, in f32 and f64, with CUDA-event times of the kernel, the plain
   version and the PyTorch call that computes the same function (the
   library yardstick, which the port never calls: torch.sparse.mm for K7
   and K1, torch.triangular_solve on a CSR factor for K2), each library
   result checked against the kernel's.
4. Main path: the frozen preconditioner (benchdata/frozen_prec.npz,
   poisson2d(128), n=16384) packed with dense_inv="auto" and 0, in f32 and
   f64; a batched M-solve of 128 seeded right-hand sides against the port's
   plain f64 CPU solve (gates: f32 1e-4, f64 1e-10 relative to max|X|);
   then HIFIR refinement with A = BSR(poisson2d(128), bs=128), nirs = 1..4,
   whose residual must fall at every step for every column and whose result
   must match the plain CPU refinement (f64, 1e-10).  The launch counts of
   this phase show that the main path went through every kernel.
5. Timing of the main path: 50 back-to-back M-solves of the same block
   per pack (one stream runs them in order, so this times what chaining
   X <- M^{-1} X would, without the f32 overflow that ||M^{-1}|| ~ 1e3
   brings to a 50-fold chain), and a
   torch.profiler breakdown of the f32 M-solves and the HIFIR apply:
   device time by kernel and the device's busy share of the time per run.

The last lines are the card's name and power limit, one JSON object with
the kernels and, last, {"ok": true, "device": {...}}.  Without a card the
script prints no result and exits with code 2.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "benchdata", "frozen_prec.npz")
NRHS = 128
CHAIN = 50
# H100 SXM: 3.35 TB/s device memory; 67 TFLOP/s in f32 outside the tensor
# cores and 67 TFLOP/s in f64 on the tensor cores (NVIDIA's data sheet).
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}


def log(*a):
    print(*a, flush=True)


def gate(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"gate failed: {what}")


def power_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class Timer:
    """CUDA-event timing: warm-up, then the median of ``iters`` launches,
    each after an L2 flush (the main path streams >100 MB of operands per
    solve, so its kernels find their inputs cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def ms(self, fn, iters=20, warmup=3, before=None) -> float:
        torch = self.torch
        for _ in range(warmup):
            if before:
                before()
            fn()
        pairs = []
        for _ in range(iters):
            if before:
                before()
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: float, flops: float, dtype: str):
    tb = nbytes / MEM_BYTES_PER_S * 1e3
    tf = flops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def csr_tensor(torch, A, dtype, device):
    return torch.sparse_csr_tensor(
        torch.as_tensor(A.indptr, dtype=torch.int64),
        torch.as_tensor(A.indices, dtype=torch.int64),
        torch.as_tensor(A.data, dtype=dtype), size=A.shape,
        check_invariants=True).to(device)


def rel_diff(Y, ref) -> float:
    return float((Y - ref).abs().max()) / max(float(ref.abs().max()), 1e-300)


def spmv_bytes(E, nrhs: int, es: int) -> int:
    """Bytes that Y = E X must move: E's entries (index and value) once, the
    rows of X that E reads once, Y once.  Row tables are format overhead."""
    return (E.nnz * (4 + es) + np.unique(E.indices).size * nrhs * es
            + E.nrows * nrhs * es)


def kernel_phases(torch, T, M, rng):
    """Each kernel against its plain version at main-path shapes."""
    import scipy.sparse as sp

    from hifir_tpu_torch.models.problems import poisson2d
    from hifir_tpu_torch.ops import bsr_spmv, spmv, trsv

    rows = []

    def library(what, fn, ref, tol):
        """Check one PyTorch call computing the same function against the
        kernel's result; return its time and difference."""
        rel = rel_diff(fn(), ref)
        log(f"  {what}: library call vs kernel rel diff {rel:.3e} "
            f"(tol {tol:.0e})")
        gate(rel <= tol, f"{what}: library call differs by {rel:.3e}")
        return T.ms(fn), rel

    def record(name, dtype, shape, Y, Yp, ms, plain_ms, lib, nbytes,
               flops, tol):
        abs_err = float((Y - Yp).abs().max())
        rel = rel_diff(Y, Yp)
        bms, by = bound(nbytes, flops, dtype)
        library_ms, library_rel = lib if lib else (None, None)
        row = dict(name=name, dtype=dtype, shape=shape, max_abs_err=abs_err,
                   rel_err=rel, tol=tol, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, library_rel_diff=library_rel,
                   bytes=nbytes, flops=flops, bound_ms=bms, bound_by=by)
        log(f"  {name:9s} {dtype:7s} {shape:34s} rel_err {rel:.3e} "
            f"(tol {tol:.0e})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"library {'-' if library_ms is None else f'{library_ms:.4f}'} ms"
            f"  bound {bms:.4f} ms ({by})")
        gate(rel <= tol, f"{name} {dtype} {shape}: rel err {rel:.3e} > {tol}")
        rows.append(row)

    A = poisson2d(128)
    for npdt in (np.float32, np.float64):
        dt = torch.float32 if npdt == np.float32 else torch.float64
        dname = str(dt).removeprefix("torch.")
        es = 4 if npdt == np.float32 else 8
        tol = 1e-5 if npdt == np.float32 else 1e-12

        # K7: BSR SpMV, A = poisson2d(128), bs=128, at 128 and 1 RHS
        Ab = bsr_spmv.bsr_from_csr(A, bs=128, dtype=npdt)
        Acsr = csr_tensor(torch, A, dt, "cuda")
        # the blocks A really has; the zero blocks that pad rows to KB are
        # format overhead
        Arows = np.repeat(np.arange(A.nrows), np.diff(A.indptr))
        nblk = np.unique(Arows // Ab.bs * Ab.nbr + A.indices // Ab.bs).size
        for nrhs in (NRHS, 1):
            X = torch.as_tensor(rng.standard_normal((Ab.nbr * Ab.bs, nrhs)),
                                dtype=dt, device="cuda")
            Y = bsr_spmv.bsr_matvec_mrhs(Ab, X)
            Yp = bsr_spmv.bsr_matvec_mrhs_plain(Ab, X)
            torch.cuda.synchronize()
            nbytes = (nblk * (Ab.bs * Ab.bs * es + 4) + 2 * X.numel() * es)
            flops = 2.0 * nblk * Ab.bs * Ab.bs * nrhs
            record("K7_bsr", dname,
                   f"nbr={Ab.nbr} kb={Ab.kb} bs={Ab.bs} nrhs={nrhs}", Y, Yp,
                   T.ms(lambda: bsr_spmv.bsr_matvec_mrhs(Ab, X)),
                   T.ms(lambda: bsr_spmv.bsr_matvec_mrhs_plain(Ab, X)),
                   library(f"K7 {dname} nrhs={nrhs} torch.sparse.mm",
                           lambda: torch.sparse.mm(Acsr, X[:A.nrows]),
                           Y[:A.nrows], tol),
                   nbytes, flops, tol)

        dp = M.to_device(dtype=npdt, dense_inv=0)
        lvl = dp.levels[0]
        host = M.precs[0]
        # K1: sliced-ELL SpMV on level 0's E and F, 128 RHS
        for nm, E, Eh in (("E", lvl.E, host.E), ("F", lvl.F, host.F)):
            X = torch.as_tensor(rng.standard_normal((E.ncols, NRHS)),
                                dtype=dt, device="cuda")
            Y = spmv.sliced_ell_matvec_mrhs(E, X)
            Yp = spmv.sliced_ell_matvec_mrhs_plain(E, X)
            torch.cuda.synchronize()
            Ecsr = csr_tensor(torch, Eh, dt, "cuda")
            record(f"K1_sell_{nm}", dname,
                   f"{E.nrows}x{E.ncols} nnz={Eh.nnz} "
                   f"buckets={len(E.blocks)} nrhs={NRHS}", Y, Yp,
                   T.ms(lambda: spmv.sliced_ell_matvec_mrhs(E, X)),
                   T.ms(lambda: spmv.sliced_ell_matvec_mrhs_plain(E, X)),
                   library(f"K1 {dname} {nm} torch.sparse.mm",
                           lambda: torch.sparse.mm(Ecsr, X), Y, tol),
                   spmv_bytes(Eh, NRHS, es), 2.0 * Eh.nnz * NRHS, tol)

        # K1 on a uniform ELL (the form an ELL operator A takes in HIFIR)
        El = spmv.ell_from_csr(host.E, dtype=npdt)
        X = torch.as_tensor(rng.standard_normal((El.ncols, NRHS)), dtype=dt,
                            device="cuda")
        Y = spmv.ell_matvec_mrhs(El, X)
        Yp = spmv.ell_matvec_mrhs_plain(El, X)
        torch.cuda.synchronize()
        record("K1_ell_E", dname, f"{El.nrows}x{El.ncols} K={El.k} "
               f"nrhs={NRHS}", Y, Yp,
               T.ms(lambda: spmv.ell_matvec_mrhs(El, X)),
               T.ms(lambda: spmv.ell_matvec_mrhs_plain(El, X)), None,
               spmv_bytes(host.E, NRHS, es), 2.0 * host.E.nnz * NRHS, tol)

        # K2: level scan on level 0's L_B and U_B schedules, 128 RHS.  The
        # library call solving the same unit triangular system is
        # torch.triangular_solve on a CSR factor (cuSPARSE SpSM): the
        # scan's slot order is a permutation that trsv_apply_mrhs's entry
        # and exit gathers undo, so it is checked against that function.
        stol = 1e-4 if npdt == np.float32 else 1e-10
        for nm, S, Th, lower in (("L", lvl.L, host.L_B, True),
                                 ("U", lvl.U, host.U_B, False)):
            nslots = S.nchunks * S.chunk
            x0 = torch.as_tensor(rng.standard_normal((nslots + 1, NRHS)),
                                 dtype=dt, device="cuda")
            x0[-1] = 0
            xw = torch.empty_like(x0)
            Y = trsv.trsv_scan(S, x0.clone())
            Yp = trsv.trsv_scan_plain(S, x0.clone())
            Ts = Th.to_scipy().tocsr()
            Ts = (sp.tril(Ts, -1) if lower else sp.triu(Ts, 1)).tocsr()
            Tcsr = csr_tensor(torch, (Ts + sp.eye(S.n, format="csr"))
                              .tocsr().sorted_indices(), dt, "cuda")
            B = torch.as_tensor(rng.standard_normal((S.n, NRHS)), dtype=dt,
                                device="cuda")
            Xs = trsv.trsv_apply_mrhs(S, B)
            torch.cuda.synchronize()
            # the function's bytes: the strict factor's entries, B and X
            nbytes = Ts.nnz * (4 + es) + 2 * S.n * NRHS * es
            flops = 2.0 * Ts.nnz * NRHS
            reset = lambda: xw.copy_(x0)   # noqa: E731
            record(f"K2_scan_{nm}", dname,
                   f"slots={nslots} K={S.cols.shape[2]} levels={S.nlevels} "
                   f"nrhs={NRHS}", Y, Yp,
                   T.ms(lambda: trsv.trsv_scan(S, xw), before=reset),
                   T.ms(lambda: trsv.trsv_scan_plain(S, xw), before=reset),
                   library(f"K2 {dname} {nm} torch.triangular_solve (CSR)",
                           lambda: torch.triangular_solve(
                               B, Tcsr, upper=not lower,
                               unitriangular=True)[0], Xs, stol),
                   nbytes, flops, tol)
    return rows


def counters():
    from hifir_tpu_torch.ops import bsr_spmv, spmv, trsv

    return {"K7": bsr_spmv.bsr_spmv_cuda, "K1": spmv.sell_spmv_cuda,
            "K2": trsv.trsv_scan_cuda}


def reset_counts():
    for f in counters().values():
        f.launches = 0


def read_counts():
    return {k: f.launches for k, f in counters().items()}


def main_path(torch, M, A, rng):
    """Frozen-operator M-solves and HIFIR refinement; returns launch counts,
    per-solve launches, and the packs for timing."""
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.ops.bsr_spmv import bsr_from_csr
    from hifir_tpu_torch.ops.spmv import ell_matvec_mrhs

    n = M.precs[0].n
    B = rng.standard_normal((n, NRHS))
    # the reference: the port's plain f64 solve on the CPU, level-scan form
    cpu = M.to_device(dtype=np.float64, device="cpu", dense_inv=0)
    ref = cpu.solve_mrhs(B).numpy()
    refmax = np.abs(ref).max()
    Ab_cpu = bsr_from_csr(A, bs=128, dtype=np.float64, device="cpu")
    ir_ref = ht.ir_apply(Ab_cpu, cpu, B, 4).numpy()

    packs = {}
    for di in ("auto", 0):
        for npdt in (np.float32, np.float64):
            t0 = time.perf_counter()
            packs[(di, np.dtype(npdt).name)] = M.to_device(dtype=npdt,
                                                           dense_inv=di)
            log(f"  pack dense_inv={di!s:4s} {np.dtype(npdt).name}: "
                f"{time.perf_counter() - t0:.2f} s (host)")
    Ab = bsr_from_csr(A, bs=128, dtype=np.float64)
    Bd = {dt: torch.as_tensor(B, dtype=getattr(torch, dt), device="cuda")
          for dt in ("float32", "float64")}
    torch.cuda.synchronize()

    per_solve = {}
    reset_counts()
    for (di, dt), dp in packs.items():
        before = read_counts()
        X = dp.solve_mrhs(Bd[dt])
        torch.cuda.synchronize()
        after = read_counts()
        per_solve[f"dense_inv={di} {dt}"] = {
            k: after[k] - before[k] for k in after}
        gate(bool(torch.isfinite(X).all()), f"solve {di} {dt}: non-finite")
        gate(tuple(X.shape) == (n, NRHS), f"solve {di} {dt}: shape")
        rel = np.abs(X.double().cpu().numpy() - ref).max() / refmax
        tol = 1e-4 if dt == "float32" else 1e-10
        log(f"  M-solve dense_inv={di!s:4s} {dt}: rel diff vs CPU f64 "
            f"{rel:.3e} (tol {tol:.0e}); launches "
            f"{per_solve[f'dense_inv={di} {dt}']}")
        gate(rel <= tol, f"M-solve dense_inv={di} {dt}: {rel:.3e} > {tol}")

    # HIFIR with A as BSR, f64: residual falls every step for every column
    dp = packs[("auto", "float64")]
    Bt = Bd["float64"]
    Xs = []
    for k in range(1, 5):
        before = read_counts()
        Xs.append(ht.ir_apply(Ab, dp, Bt, k))
    torch.cuda.synchronize()
    launches = read_counts()
    per_solve["hifir nirs=4 float64"] = {
        k: launches[k] - before[k] for k in launches}
    log(f"  HIFIR nirs=4 launches {per_solve['hifir nirs=4 float64']}")
    # the residual check's own products run after the counts were read
    res = np.array([torch.linalg.vector_norm(
        Bt - ell_matvec_mrhs(Ab, Xk), dim=0).cpu().numpy() for Xk in Xs])
    Xk = Xs[-1]
    rel_res = res / np.linalg.norm(B, axis=0)
    log("  HIFIR (BSR A, f64) max relative residual per step: "
        + ", ".join(f"{v:.3e}" for v in rel_res.max(axis=1)))
    gate(bool(np.all(res[1:] < res[:-1])),
         "HIFIR residual did not fall at every step for every column")
    rel = np.abs(Xk.cpu().numpy() - ir_ref).max() / np.abs(ir_ref).max()
    log(f"  HIFIR nirs=4 vs CPU plain refinement: rel diff {rel:.3e} "
        "(tol 1e-10)")
    gate(rel <= 1e-10, f"HIFIR vs CPU: {rel:.3e} > 1e-10")
    return launches, per_solve, packs, Bd, Ab, rel_res.max(axis=1)


def time_main_path(torch, packs, Bd, Ab, nnz):
    import hifir_tpu_torch as ht

    out = {}
    for (di, dt), dp in packs.items():
        B = Bd[dt]
        for _ in range(3):
            dp.solve_mrhs(B)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        for _ in range(CHAIN):
            dp.solve_mrhs(B)
        e.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / CHAIN
        ms = s.elapsed_time(e) / CHAIN
        key = f"dense_inv={di} {dt}"
        out[key] = dict(ms_per_solve=ms, us_per_rhs=ms * 1e3 / NRHS,
                        nnz_per_s=nnz / (ms * 1e-3 / NRHS),
                        host_ms_per_solve=host_ms)
        log(f"  {key:22s}: {ms:.4f} ms/solve, {ms * 1e3 / NRHS:.4f} us/RHS, "
            f"{nnz / (ms * 1e-3 / NRHS):.4e} nnz(M)/s "
            f"(host wall {host_ms:.4f} ms/solve)")
    dp = packs[("auto", "float64")]
    B = Bd["float64"]
    ht.ir_apply(Ab, dp, B, 4)
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(5):
        ht.ir_apply(Ab, dp, B, 4)
    e.record()
    torch.cuda.synchronize()
    out["hifir_nirs4_bsr_f64"] = dict(ms_per_apply=s.elapsed_time(e) / 5)
    log(f"  HIFIR nirs=4 BSR f64: {s.elapsed_time(e) / 5:.4f} ms/apply")
    return out


def _kernel_name(name: str) -> str:
    for k in ("bsr_spmv_kernel", "sell_spmv_kernel", "trsv_level_kernel"):
        if k in name:
            return k
    return name if len(name) <= 70 else name[:67] + "..."


def profile_phase(torch, packs, Bd, Ab, timing, reps=5):
    """Where the time goes in the f32 M-solves and the f64 HIFIR apply:
    device time by kernel from torch.profiler over ``reps`` runs, and the
    device's busy share of the unprofiled time per run measured above."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import hifir_tpu_torch as ht

    runs = {f"dense_inv={di} float32": (
        lambda dp=packs[(di, "float32")]: dp.solve_mrhs(Bd["float32"]))
        for di in ("auto", 0)}
    runs["hifir_nirs4_bsr_f64"] = lambda: ht.ir_apply(
        Ab, packs[("auto", "float64")], Bd["float64"], 4)
    out = {}
    for key, run in runs.items():
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        by = {}
        for ev in prof.events():
            if ev.device_type != DeviceType.CUDA:
                continue
            name = _kernel_name(ev.name)
            us, cnt = by.get(name, (0.0, 0))
            by[name] = (us + ev.time_range.elapsed_us(), cnt + 1)
        busy_ms = sum(us for us, _ in by.values()) / reps / 1e3
        wall_ms = (timing[key].get("ms_per_solve")
                   or timing[key]["ms_per_apply"])
        top = sorted(by.items(), key=lambda kv: -kv[1][0])[:8]
        out[key] = dict(
            device_ms_per_run=busy_ms,
            device_ops_per_run=sum(c for _, c in by.values()) / reps,
            busy_share=busy_ms / wall_ms if busy_ms else None,
            top=[dict(name=n, ms_per_run=us / reps / 1e3,
                      count_per_run=c / reps) for n, (us, c) in top])
        if not busy_ms:
            log(f"  {key}: the profiler saw no device time (not measured)")
            continue
        log(f"  {key}: device busy {busy_ms:.4f} of {wall_ms:.4f} ms/run "
            f"({100 * busy_ms / wall_ms:.1f}%), "
            f"{out[key]['device_ops_per_run']:.0f} device ops/run")
        for t in out[key]["top"]:
            log(f"    {t['ms_per_run']:.4f} ms  x{t['count_per_run']:.0f}"
                f"  {t['name']}")
    return out


_SOURCES = {
    "K7": ("K7_bsr", "cuda", "hifir_tpu_torch/csrc/kernels.cu",
           "hifir_tpu/ops/pallas_spmv.py:133"),
    "K1": ("K1_sell", "cuda", "hifir_tpu_torch/csrc/kernels.cu",
           "hifir_tpu/ops/spmv.py:167"),
    "K2": ("K2_scan", "cuda", "hifir_tpu_torch/csrc/kernels.cu",
           "hifir_tpu/ops/trsv.py:544"),
}
# the kernel-phase row that stands for each kernel in the summary line: the
# shape and dtype it runs at on the main path (HIFIR's A-product is f64 at
# 128 RHS; the M-solve kernels are timed in f32, the bench dtype)
_MAIN_ROW = {"K7": ("K7_bsr", "float64", f"nrhs={NRHS}"),
             "K1": ("K1_sell_E", "float32", ""),
             "K2": ("K2_scan_L", "float32", "")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="directory for the full JSON report and nvcc log")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import hifir_tpu_torch as ht
    from hifir_tpu_torch.kernels.build import (load_kernels, nvcc_path,
                                               nvcc_version)
    from hifir_tpu_torch.models.problems import poisson2d

    t_start = time.perf_counter()
    smi = power_line()
    log("== toolchain")
    log(json.dumps({"python": sys.version.split()[0],
                    "torch": torch.__version__, "cuda": torch.version.cuda,
                    "nvcc": nvcc_path(), "nvcc_version": nvcc_version(),
                    "gpu": torch.cuda.get_device_name(0),
                    "device_count": torch.cuda.device_count(),
                    "nvidia_smi": smi}))

    log("== build")
    kl = load_kernels()
    log(f"  {kl.path.name}: nvcc {kl.build_seconds:.2f} s")

    rng = np.random.default_rng(args.seed)
    M = ht.load_prec(FIXTURE)
    A = poisson2d(128)
    nnz = M.nnz()
    log(f"  frozen fixture: n={M.precs[0].n} levels={len(M.precs)} "
        f"nnz(M)={nnz}")
    T = Timer(torch)

    log("== kernel phases (kernel vs plain version on the card)")
    rows = kernel_phases(torch, T, M, rng)

    log("== main path: frozen-operator M-solve and HIFIR (BSR A)")
    launches, per_solve, packs, Bd, Ab, ir_res = main_path(torch, M, A, rng)
    log(f"  launches on the main path: {launches}")
    for k, c in launches.items():
        gate(c > 0, f"kernel {k} was not launched on the main path")

    log(f"== timing: {CHAIN} back-to-back M-solves, {NRHS} RHS")
    timing = time_main_path(torch, packs, Bd, Ab, nnz)

    log("== where the time goes (torch.profiler)")
    prof = profile_phase(torch, packs, Bd, Ab, timing)

    kernels = []
    for k, (name, route, src, repl) in _SOURCES.items():
        rname, rdt, rshape = _MAIN_ROW[k]
        row = next(r for r in rows if r["name"] == rname
                   and r["dtype"] == rdt and rshape in r["shape"])
        kernels.append(dict(
            name=name, route=route, source=src, replaces=repl,
            launches=launches[k], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], dtype=rdt, shape=row["shape"]))

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(nvidia_smi=smi, kernel_rows=rows,
                           main_path_launches=launches,
                           launches_per_solve=per_solve, timing=timing,
                           profile=prof,
                           hifir_rel_residual=list(map(float, ir_res)),
                           seconds=time.perf_counter() - t_start), f,
                      indent=1)
        with open(os.path.join(args.out, "nvcc_ptxas.txt"), "w") as f:
            f.write(kl.ptxas_log)
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
