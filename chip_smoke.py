#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hifir_tpu_torch) on one NVIDIA GPU; check it.

Run from the root of a checkout, on a machine with a card and nvcc:

    python3 chip_smoke.py [--seed 0] [--out DIR]

Phases, in order; any failed gate raises and the script exits non-zero:

1. Toolchain: torch, CUDA, nvcc, the card's name and power limit.
2. Build the hand-written kernels (csrc/kernels.cu) with nvcc.
3. Kernel phases: each kernel (K7 BSR SpMV, K1 sliced-ELL SpMV, K2
   triangular solve on a level schedule) against its plain PyTorch version
   on the card, at the main path's shapes, in f32 and f64, with CUDA-event
   times of the kernel, the plain version and the PyTorch call that
   computes the same function (the library yardstick, which the port never
   calls: torch.sparse.mm for K7 and K1, torch.triangular_solve on a CSR
   factor for K2), each library result checked against the kernel's.  K7
   runs at 128, 8 and 1 right-hand sides, so that each of its three paths
   (DMMA, 3xTF32, streaming) is held against the plain version; K2 runs
   B to X on both levels' factors at 128 and 1 right-hand sides.  Sweeps
   beside the rows: K7's paths at 1, 2 and 4 right-hand sides; and the
   streaming path at 1 right-hand side against a plain read kernel and a
   torch sum over the same blocks (what reading them alone takes), each
   timed after the timer's writing L2 flush and after a reading one.
4. Main path: the frozen preconditioner (benchdata/frozen_prec.npz,
   poisson2d(128), n=16384) packed with dense_inv="auto" and 0, in f32 and
   f64; a batched M-solve of 128 seeded right-hand sides against the port's
   plain f64 CPU solve (gates: f32 1e-4, f64 1e-10 relative to max|X|);
   then HIFIR refinement with A = BSR(poisson2d(128), bs=128), nirs = 1..4,
   whose residual must fall at every step for every column and whose result
   must match the plain CPU refinement (f64, 1e-10).  The launch counts of
   this phase show that the main path went through every kernel: K2 once
   per triangular solve on a schedule (8 per dense_inv=0 M-solve on the
   fixture), K7 3 times per nirs=4 HIFIR apply.
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
# cores, 67 TFLOP/s in f64 on the tensor cores and 495 TFLOP/s in TF32
# (NVIDIA's data sheet).  K7's f32 tensor-core path does each product as
# three TF32 products (3xTF32), so its least time for 2*m*n*k FLOP of f32
# work counts 3 * that at the TF32 rate.
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
TF32X3_FLOPS = 495e12 / 3


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
    solve, so its kernels find their inputs cold).  The flush writes 256 MB
    and so leaves L2 full of dirty lines, which the timed kernel's own
    traffic writes back; ``clean=True`` flushes by reading instead."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def ms(self, fn, iters=20, warmup=3, clean=False) -> float:
        torch = self.torch
        flush = self.flush.sum if clean else self.flush.zero_
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            flush()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: float, flops: float, dtype: str, peak: float = None):
    tb = nbytes / MEM_BYTES_PER_S * 1e3
    tf = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
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
    """Each kernel against its plain version at main-path shapes; returns
    the rows and the sweeps."""
    import scipy.sparse as sp

    from hifir_tpu_torch.kernels.build import check, load_kernels
    from hifir_tpu_torch.models.problems import poisson2d
    from hifir_tpu_torch.ops import bsr_spmv, spmv, trsv

    rows, sweeps = [], []

    def library(what, fn, ref, tol):
        """Check one PyTorch call computing the same function against the
        kernel's result; return its time and difference."""
        rel = rel_diff(fn(), ref)
        log(f"  {what}: library call vs kernel rel diff {rel:.3e} "
            f"(tol {tol:.0e})")
        gate(rel <= tol, f"{what}: library call differs by {rel:.3e}")
        return T.ms(fn), rel

    def record(name, dtype, shape, Y, Yp, ms, plain_ms, lib, nbytes,
               flops, tol, peak=None):
        abs_err = float((Y - Yp).abs().max())
        rel = rel_diff(Y, Yp)
        bms, by = bound(nbytes, flops, dtype, peak)
        library_ms, library_rel = lib if lib else (None, None)
        row = dict(name=name, dtype=dtype, shape=shape, max_abs_err=abs_err,
                   rel_err=rel, tol=tol, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, library_rel_diff=library_rel,
                   bytes=nbytes, flops=flops, bound_ms=bms, bound_by=by,
                   share_of_bound=bms / ms,
                   vs_library=None if library_ms is None else ms / library_ms)
        log(f"  {name:9s} {dtype:7s} {shape:44s} rel_err {rel:.3e} "
            f"(tol {tol:.0e})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"library {'-' if library_ms is None else f'{library_ms:.4f}'} ms"
            f"  bound {bms:.4f} ms ({by})")
        gate(rel <= tol, f"{name} {dtype} {shape}: rel err {rel:.3e} > {tol}")
        rows.append(row)

    def sweep(what, dtype, fn, ref, tol):
        """Time a forced variant after checking it against ``ref``."""
        Y = fn()
        torch.cuda.synchronize()
        rel = rel_diff(Y, ref)
        gate(rel <= tol, f"{what} {dtype}: rel err {rel:.3e} > {tol}")
        ms = T.ms(fn)
        sweeps.append(dict(what=what, dtype=dtype, ms=ms, rel_err=rel))
        log(f"  sweep {what:48s} {dtype:7s} {ms:.4f} ms (rel err {rel:.1e})")

    A = poisson2d(128)
    for npdt in (np.float32, np.float64):
        dt = torch.float32 if npdt == np.float32 else torch.float64
        dname = str(dt).removeprefix("torch.")
        es = 4 if npdt == np.float32 else 8
        tol = 1e-5 if npdt == np.float32 else 1e-12
        tensor = "tf32x3" if npdt == np.float32 else "dmma"

        # K7: BSR SpMV, A = poisson2d(128), bs=128
        Ab = bsr_spmv.bsr_from_csr(A, bs=128, dtype=npdt)
        Acsr = csr_tensor(torch, A, dt, "cuda")
        # the blocks A really has; the zero blocks that pad rows to KB are
        # format overhead
        Arows = np.repeat(np.arange(A.nrows), np.diff(A.indptr))
        nblk = np.unique(Arows // Ab.bs * Ab.nbr + A.indices // Ab.bs).size
        for nrhs in (NRHS, 8, 1):
            X = torch.as_tensor(rng.standard_normal((Ab.nbr * Ab.bs, nrhs)),
                                dtype=dt, device="cuda")
            path = bsr_spmv.bsr_path(dt, nrhs)
            Y = bsr_spmv.bsr_matvec_mrhs(Ab, X)
            Yp = bsr_spmv.bsr_matvec_mrhs_plain(Ab, X)
            torch.cuda.synchronize()
            nbytes = (nblk * (Ab.bs * Ab.bs * es + 4) + 2 * X.numel() * es)
            flops = 2.0 * nblk * Ab.bs * Ab.bs * nrhs
            record("K7_bsr", dname,
                   f"nbr={Ab.nbr} kb={Ab.kb} bs={Ab.bs} nrhs={nrhs} "
                   f"path={path}", Y, Yp,
                   T.ms(lambda: bsr_spmv.bsr_matvec_mrhs(Ab, X)),
                   T.ms(lambda: bsr_spmv.bsr_matvec_mrhs_plain(Ab, X)),
                   library(f"K7 {dname} nrhs={nrhs} torch.sparse.mm",
                           lambda: torch.sparse.mm(Acsr, X[:A.nrows]),
                           Y[:A.nrows], tol),
                   nbytes, flops, tol,
                   TF32X3_FLOPS if path == "tf32x3" else None)
        # K7's paths where the choice turns
        for nrhs in (1, 2, 4):
            X = torch.as_tensor(rng.standard_normal((Ab.nbr * Ab.bs, nrhs)),
                                dtype=dt, device="cuda")
            Yp = bsr_spmv.bsr_matvec_mrhs_plain(Ab, X)
            paths = ["stream", tensor] if nrhs <= 2 else [tensor]
            for p in paths:
                sweep(f"K7 nrhs={nrhs} path={p}", dname,
                      lambda: bsr_spmv.bsr_spmv_cuda(Ab, X, path=p), Yp, tol)
        # the streaming path against what reading its blocks alone takes:
        # a plain 16-byte-load read kernel over the same bytes, and torch's
        # sum, under the timer's write flush and under a clean (read) flush
        X = torch.as_tensor(rng.standard_normal((Ab.nbr * Ab.bs, 1)),
                            dtype=dt, device="cuda")
        blocks, mb = Ab.blocks, Ab.blocks.numel() * es
        sink = torch.zeros(1, dtype=torch.int32, device="cuda")
        lib = load_kernels().lib

        def read_blocks():
            check(lib.read_rate(blocks.data_ptr(), mb, sink.data_ptr(),
                                0x9E3779B9, torch.cuda.current_stream()
                                .cuda_stream), "read_rate")

        for what, fn in (("K7 stream nrhs=1",
                          lambda: bsr_spmv.bsr_spmv_cuda(Ab, X)),
                         ("read kernel over the BSR blocks", read_blocks),
                         ("torch sum over the BSR blocks", blocks.sum)):
            for clean in (False, True):
                ms = T.ms(fn, clean=clean)
                flush = "read" if clean else "write"
                sweeps.append(dict(what=what, dtype=dname, flush=flush, ms=ms,
                                   bytes=mb, tb_per_s=mb / ms / 1e9))
                log(f"  read rate {what:34s} {dname:7s} {flush:5s} flush "
                    f"{ms:.4f} ms ({mb / ms / 1e9:.3f} TB/s of blocks)")

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
        Ecsr = csr_tensor(torch, host.E, dt, "cuda")
        X = torch.as_tensor(rng.standard_normal((El.ncols, NRHS)), dtype=dt,
                            device="cuda")
        Y = spmv.ell_matvec_mrhs(El, X)
        Yp = spmv.ell_matvec_mrhs_plain(El, X)
        torch.cuda.synchronize()
        record("K1_ell_E", dname, f"{El.nrows}x{El.ncols} K={El.k} "
               f"nrhs={NRHS}", Y, Yp,
               T.ms(lambda: spmv.ell_matvec_mrhs(El, X)),
               T.ms(lambda: spmv.ell_matvec_mrhs_plain(El, X)),
               library(f"K1 {dname} uniform ELL E torch.sparse.mm",
                       lambda: torch.sparse.mm(Ecsr, X), Y, tol),
               spmv_bytes(host.E, NRHS, es), 2.0 * host.E.nnz * NRHS, tol)

        # K2: B to X on both levels' L_B and U_B schedules.  The library
        # call solving the same unit triangular system is
        # torch.triangular_solve on a CSR factor (cuSPARSE SpSM), in row
        # order like the kernel's B and X.
        stol = 1e-4 if npdt == np.float32 else 1e-10
        for li, (lv, hp) in enumerate(zip(dp.levels, M.precs)):
            for nm, S, Th, lower in (("L", lv.L, hp.L_B, True),
                                     ("U", lv.U, hp.U_B, False)):
                nslots = S.nchunks * S.chunk
                Ts = Th.to_scipy().tocsr()
                Ts = (sp.tril(Ts, -1) if lower else sp.triu(Ts, 1)).tocsr()
                Tcsr = csr_tensor(torch, (Ts + sp.eye(S.n, format="csr"))
                                  .tocsr().sorted_indices(), dt, "cuda")
                for nrhs in (NRHS, 1):
                    B = torch.as_tensor(rng.standard_normal((S.n, nrhs)),
                                        dtype=dt, device="cuda")
                    Xk = trsv.trsv_apply_mrhs(S, B)
                    Xp = trsv.trsv_apply_plain(S, B)
                    torch.cuda.synchronize()
                    K = S.cols.shape[2]
                    # the function's bytes: the strict factor's entries, B
                    # and X
                    nbytes = Ts.nnz * (4 + es) + 2 * S.n * nrhs * es
                    record(f"K2_trsv_{nm}", dname,
                           f"level={li} slots={nslots} K={K} "
                           f"levels={S.nlevels} nrhs={nrhs} "
                           f"x={trsv.trsv_shape(nslots, es)}",
                           Xk, Xp,
                           T.ms(lambda: trsv.trsv_apply_mrhs(S, B)),
                           T.ms(lambda: trsv.trsv_apply_plain(S, B)),
                           library(f"K2 {dname} level {li} {nm} nrhs={nrhs} "
                                   "torch.triangular_solve (CSR)",
                                   lambda: torch.triangular_solve(
                                       B, Tcsr, upper=not lower,
                                       unitriangular=True)[0], Xk, stol),
                           nbytes, 2.0 * Ts.nnz * nrhs, tol)
    return rows, sweeps


def ptxas_report(log_text: str) -> dict:
    """Registers, spills and shared memory of each kernel from nvcc's
    ``-Xptxas -v`` log."""
    import re

    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[name]["static_smem"] = int(m.group(1))
    return out


def counters():
    from hifir_tpu_torch.ops import bsr_spmv, spmv, trsv

    return {"K7": bsr_spmv.bsr_spmv_cuda, "K1": spmv.sell_spmv_cuda,
            "K2": trsv.trsv_apply_cuda}


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
    from hifir_tpu_torch.ops.trsv import TrsvSchedule

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
        # one K2 launch per triangular solve on a schedule: L and U of every
        # such level, once down and once up
        want = 2 * sum(isinstance(f, TrsvSchedule) and f.nchunks > 0
                       for lvl in dp.levels for f in (lvl.L, lvl.U))
        got = per_solve[f"dense_inv={di} {dt}"]["K2"]
        gate(got == want, f"M-solve dense_inv={di} {dt}: {got} K2 launches, "
             f"{want} schedule-form triangular solves")

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
    k7 = per_solve["hifir nirs=4 float64"]["K7"]
    gate(k7 == 3, f"HIFIR nirs=4: {k7} K7 launches, expected 3")
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
    for k in ("bsr_mma_kernel", "bsr_stream_kernel", "sell_spmv_kernel",
              "trsv_solve_kernel"):
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
    "K2": ("K2_trsv", "cuda", "hifir_tpu_torch/csrc/kernels.cu",
           "hifir_tpu/ops/trsv.py:544"),
}
# the kernel-phase row that stands for each kernel in the summary line: the
# shape and dtype it runs at on the main path (HIFIR's A-product is f64 at
# 128 RHS; the M-solve kernels are timed in f32, the bench dtype)
_MAIN_ROW = {"K7": ("K7_bsr", "float64", (f"nrhs={NRHS} ",)),
             "K1": ("K1_sell_E", "float32", ()),
             "K2": ("K2_trsv_L", "float32", ("level=0 ", f"nrhs={NRHS} "))}


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
    rows, sweeps = kernel_phases(torch, T, M, rng)

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
                   and r["dtype"] == rdt
                   and all(x in r["shape"] for x in rshape))
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
                           sweeps=sweeps,
                           ptxas=ptxas_report(kl.ptxas_log),
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
