#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hifir_tpu_torch) on one NVIDIA GPU; check it.

Run from the root of a checkout, on a machine with a card and nvcc:

    python3 chip_smoke.py [--seed 0] [--out DIR]

Phases, in order; any failed gate raises and the script exits non-zero:

1. Toolchain: torch, CUDA, nvcc, the card's name and power limit.
2. Build the hand-written kernels (csrc/kernels.cu) with nvcc and, at the
   same time, the native host library (native/src/*.cpp) with g++; the
   seconds of each and the library's name.
3. Kernel phases: each kernel (K7 BSR SpMV, K1 sliced-ELL SpMV with its
   fused C - A X epilogue, K2 triangular solve on a level schedule) against
   its plain PyTorch version on the card, at the main path's shapes, in f32
   and f64, with CUDA-event times of the kernel, the plain version and the
   PyTorch call that computes the same function (the library yardstick,
   which the port never calls: torch.sparse.mm for K7 and K1's product,
   torch.addmm(C, A, X, alpha=-1) on a CSR A for K1's C - A X,
   torch.triangular_solve on a CSR factor for K2), each library result
   checked against the kernel's.  K7 runs at 128, 8 and 1 right-hand
   sides, so that each of its three paths (DMMA, 3xTF32, streaming) is
   held against the plain version; K1 runs level 0's E and F in place at
   128, 8 and 1 (its wide and narrow shapes) and as the product at 128,
   and the heaviest Off_b of each blocked inverse at 128 and 1, in the
   form its call site uses; K2 runs B to X on both levels' factors at 128
   and 1 right-hand sides; K1 with sign=+1 (C + A X, the products') runs
   the nonsymmetric fixture's level-0 U_B in place at 128 and 1.  Sweeps
   beside the rows: the timer's launch
   floor (a kernel that reads 16 bytes) and each K1 row again after a
   reading L2 flush; K7's paths at 1, 2 and 4 right-hand sides; and the
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
   fixture), K1 once per operator with entries (28 per dense_inv="auto"
   M-solve, 4 per dense_inv=0), K7 3 times per nirs=4 HIFIR apply.
5. Timing of the main path: 50 back-to-back M-solves of the same block
   per pack (one stream runs them in order, so this times what chaining
   X <- M^{-1} X would, without the f32 overflow that ||M^{-1}|| ~ 1e3
   brings to a 50-fold chain), and a
   torch.profiler breakdown of the f32 M-solves and the HIFIR apply:
   device time by kernel and the device's busy share of the time per run.
6. Surface, on the nonsymmetric fixture hifir_tpu_torch/data/
   convdiff2d_128_prec.npz (n=16384, two levels, a 203x203 QRCP tail) and
   A = convdiff2d(128), each part with the launch counts set to 0 just
   before it and read just after, each reference the port's plain f64 CPU
   run: the adjoint M-solve of 128 seeded RHS on packs dense_inv "auto"
   and 0 in f32 and f64 (gates 1e-4 / 1e-10, and the forward solve beside
   it), the adjoint identity <Y, M^-1 X> = <M^-H Y, X> in f64 (1e-10 of
   |Y| |M^-1 X| per column pair), and K1/K2 launches per adjoint solve by
   the forward rule on the adjoint pack; the runtime rank (r = the tail's
   rank equals the pack's within 1e-12, r = 3/4 of it matches the CPU
   within 1e-10), forward and adjoint; a constant-mode null-space filter
   (every column's mean within 1e-12 of max|X|); the products M X and
   M^H X on 8 and 128 columns (1e-10 against the CPU, K1's sign=+1
   launches counted, and M (M^-1 B) = B, M^H (M^-H B) = B within 1e-9);
   the GMRES drivers to rtol 1e-6 (gmres_hif and fgmres_hifir with the
   tail's rank on one RHS with a sliced-ELL A, gmres_mrhs on 128 RHS with
   A = BSR(bs=128), which launches K7): flag 0, true residual within
   1.01 rtol, iteration (cycle) counts within one of the CPU run.  Then
   the timing: adjoint and forward M-solves per pack, the products, and
   each driver's time to solution, device busy share (torch.profiler),
   host syncs and peak memory.
7. Complex, on the complex nonsymmetric fixture hifir_tpu_torch/data/
   convdiff2d_128_c_prec.npz (n=16384, two levels, a 25x25 QRCP tail) and
   A = shift_diagonal(convdiff2d(128)), drawing from its own generator
   (--seed + 2), each part with the launch counts and the plain-version
   calls set to 0 just before it and read just after, each reference the
   port's plain c128 CPU run: the complex K1 rows (level-0 E in place at
   128, 8 and 1 RHS, level-0 U_B with sign +1 at 128) and K2 rows (level-0
   L_B of the dense_inv=0 pack at 128 and 1) in c64 and c128 against
   their plain versions (1e-5 / 1e-12 of max|Y|), with kernel, plain,
   library (torch.addmm / torch.triangular_solve on a complex CSR, "none"
   where this build has no complex CUDA path) and bound ms, a complex row
   counting 8 real FLOP per entry and column at the SIMT rate of its real
   type; forward and adjoint M-solves of 128 RHS on packs dense_inv "auto"
   and 0 in c64 and c128 (1e-4 / 1e-10) with K1 and K2 launches per solve
   from the packs' forms; the adjoint identity in c128 (1e-10) and the
   failure of the unconjugated pairing <Y, M^-1 X> = <M^-T Y, X> (> 1e-3),
   which shows the fixture catches a lost conjugate; the runtime rank both
   ways; the products both ways on 8 and 128 columns and M (M^-1 B) = B,
   M^H (M^-H B) = B (1e-9); gmres_hif, fgmres_hifir (1 RHS) and gmres_mrhs
   (128 RHS) with a sliced-ELL A, restart 10, rtol 1e-6: flag 0, true
   residual within 1.01 rtol, counts within one of the CPU run.  No part
   launches K7 or calls a plain version on the card.
8. Complex timing: 50 back-to-back forward M-solves of the 128 complex
   columns per pack and a torch.profiler breakdown of each.
9. Factorize, drawing from its own generator (--seed + 3), each part with
   the launch counts set to 0 just before it and read just after: the
   port's own factorize on its numpy anchors (native library switched off,
   as the JAX package wrote the fixtures) of convdiff2d(128) with the
   fixture's options, gated equal to hifir_tpu_torch/data/
   convdiff2d_128_prec.npz (patterns exactly, values 1e-12), and of
   poisson2d(256) with bench.py's options (seconds with the host's CPU
   model, levels, nnz(M), fill; its native factorize's seconds beside
   them); the anchors' packs dense_inv "auto" in f32 and
   f64 and 0 in f32 with their bytes by operand; forward and adjoint
   M-solves of 128 seeded RHS against the port's plain f64 CPU solve
   (1e-4 / 1e-10) with K1 and K2 launches per solve from the packs' forms
   (the auto packs launch K2 on level 0, m = 61983); HIFIR nirs = 4, f64,
   A = BSR(poisson2d(256), bs=128): the residual falls every step, K7 3
   and K1, K2 four solves' worth.
10. Factorize timing: 50 back-to-back M-solves per poisson-256 pack, both
   directions, 5 HIFIR applies, each with a torch.profiler breakdown.
11. K8, the device QRCP of the dense tail (one cooperative launch of
   qrcp_kernel), against its plain version (the eager loop) on the card in
   f64 and f32: the two real fixture tails, the 40x40 rank-25 matrix,
   seeded Gaussian n = 1, 2, 33, 736, 2000 (2000 takes the global-memory
   layout, the others shared memory) and the 8x8 tie set (identity,
   permutation, equal columns, zero column, zero matrix), each under
   torch.cuda.set_sync_debug_mode("error") with one launch by the counter
   and one qrcp_kernel a factorization in the profiler: pivots equal (f32:
   up to a certified tie at f32 precision), Q and R within 1e-12 (f64) /
   1e-5 (f32, or twice the plain version's own f32 distance from its f64
   factors where that is larger), |QR - AP| and |Q^T Q - I| <= 1e-13 /
   1e-4; on the fixtures in f64 pivots equal to scipy geqp3's and the rank
   to the host's; a grid that cannot be co-resident refused.  Its ms (and
   us a column step) at the fixtures' tails and n = 2000 beside the plain
   route on the card, host geqp3 and torch.geqrf (unpivoted).  Then the K8
   path, its launches counted from 0: the auto f64 M-solve of a
   tail_on_device pack within 1e-10 of the host-tail pack on each fixture
   (both to_device calls timed), HIF.factorize(convdiff2d(128))
   with device_tail=1 against 0 (host seconds, rank, M-solve 1e-8); the
   complex tail's host fallback; the rank rule on 40x40 rank-25 QRCP and
   SYEIG tails: r = rank + 1 equal to r = 0 (1e-12) and to the host's
   truncated solve (1e-10), both directions.  The "global_x" layout (x,
   map and inverse in global scratch) forced on Gaussian n = 33 and 736
   against the plain route, both dtypes, and f64 n = 14465 once, the first
   n the older layouts refuse on 132 SMs: one launch, no host sync,
   |AP - QR| / |A| and |Q^T Q - I| <= 1e-11, piv a permutation led by the
   column of largest norm (the plain route is not run at that n).
12. 1M (BASELINE config 2), generator --seed + 4, each part counted: the
   native factorize of poisson2d(1024) with bench.py's robust options
   (seconds with the host CPU, levels, nnz(M), fill), packs "auto" in f32
   and f64 (seconds, bytes by operand, each level's schedule counts), the
   device M-solve at 64 and at 1 RHS against the host native f64 solve
   (1e-4 / 1e-10 of max|X|; K1 and K2 launches from the packs' forms),
   their CUDA-event times beside the host single-RHS solve (bench.py's
   baseline), a torch.profiler breakdown of the 64-RHS f32 solve (K1/K2
   launches in the trace gated equal to the counters), gmres_hif with a
   sliced-ELL A and the device M against the host gmres_np with the host M
   (restart 30, rtol 1e-6, one RHS: flag 0, true residual within 1.01
   rtol, counts within one), and HIFIR nirs = 4 in f64 with A as sliced
   ELL (the residual falls every step for every column).
13. Saddle point (bench.py's correctness leg), generator --seed + 5: the
   native factorize of saddle_point_stokes(64), packed in f32, 10
   Richardson steps with the f64 residual on the host and the M-solve on
   the card; the median contraction of the first 5 steps must be < 0.5.
14. Distribution, generator --seed + 6, eight ranks on the card
   (hifir_tpu_torch.parallel), each part counted: DistPrec on
   poisson2d(512) in f64 and f32 against the host and single-device
   solves (1e-12 / 1e-4), timed and profiled; every one-group run takes
   one chunk sweep (K10a redesigned) a factor application and no
   per-chunk K10a; poisson2d(64)'s halo, all_gather and whole-vector
   forms, then its halo and all_gather forms on two groups of the one
   card, where K10a runs a chunk a group; the sharded and halo SpMV and
   the IR step on a (2, 4) mesh; the ring Schur (K10b) under dist_schur=1
   on convdiff2d(128), one K10b launch a ring step; PartitionedHIF with
   eight parts; then the rows of K10a, the sweep (one application of
   level 0's L) and K10b against their plain versions; K10b (generator
   --seed + 7) also at a seeded shape of its block and global tiers and on
   edge cases (W = 1, 512, 513, long runs, all-sentinel and padded rows)
   through every tier that holds them: columns equal, values 1e-12 /
   1e-5, two launches bitwise equal.
15. Entry points (hifir_tpu_torch.entry, the counterpart of
   __graft_entry__.py), each part counted: entry()'s fn(*args), the f32
   M-solve of convdiff2d(12) on 8 columns of ones, against the host f64
   solve (1e-4 of max|X|) with K1 and K2 launches by the pack's forms;
   dryrun_multichip(8) with its asserts as gates (IR residual falls, halo
   engaged with >= 8 chunks a level, exchange below the all_gather's,
   DistPrec solve within 1e-8), one sweep launch a factor application, no
   plain-version call, and its DistPrec solve's time.
16. The DistPrec path matrix, generator --seed + 8, eight ranks: the
   symmetric (LDL^T, poisson2d(64), is_symm=1), general nonsymmetric and
   pivoting (convdiff2d(64), pivot on) factorizations with the JAX
   distribution tests' options, each in the halo and the all_gather form,
   f64 and f32, against the host solve (1e-12 / 1e-4 of max|x|), one sweep
   launch a factor application, each form's solve time.
17. The device demos (hifir_tpu_torch.examples) in-process:
   demo_device_batch (poisson2d(128), f32 64-RHS solve within 1e-4 of the
   host on 8 columns, fgmres_hifir flag 0 and residual within 1.01 rtol)
   and demo_pseudoinverse_device (the null space found; relative residual
   and distance to pinv within the module's bounds; one f32 filtered apply
   within 1e-4 of the host's filtered solve).
18. 3D, generator --seed + 9, each part counted: the native factorize of
   poisson3d(64) (n = 262144) with Options(verbose=0) (seconds with the
   host CPU, levels, tail, fill), packs "auto" in f32 and f64 (seconds,
   bytes by operand, schedule counts; the f64 adjoint pack), the forward
   M-solve at 128 and 1 RHS in both dtypes and the adjoint at 128 RHS in
   f64 against the host native solves on 8 spread columns (1e-4 / 1e-10
   of max|X|) with K1 and K2 launches by the packs' forms, their times,
   K2 alone on each schedule, a torch.profiler breakdown of the 128-RHS
   f32 solve, and gmres_hif in f64 against the host gmres_np (flag 0,
   true residual within 1.01 rtol, iterations within one).

Every torch.profiler breakdown discards one profiled warm-up run, leaves
PROFILE_PAD_S of idle host at each end of the window (the tracer drops
device records whose clock-converted times fall outside it) and gates the
K1, K2 and K7 launches in its trace equal to the launch counters over the
same runs; a window that lost records is taken again, at most
PROFILE_TAKES times in all.  Lines with a time, a size or a share carry the
card's name and power limit in brackets.  The last lines are the card's
name and power limit, one JSON object with the kernels (K8's at the
fixtures' tails in f64) and, last, {"ok": true, "device": {...}}.
Without a card the
script prints no result and exits with code 2.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "benchdata", "frozen_prec.npz")
CONVDIFF = os.path.join(ROOT, "hifir_tpu_torch", "data",
                        "convdiff2d_128_prec.npz")
CONVDIFF_C = os.path.join(ROOT, "hifir_tpu_torch", "data",
                          "convdiff2d_128_c_prec.npz")
NRHS = 128
CHAIN = 50
# H100 SXM: 3.35 TB/s device memory; 67 TFLOP/s in f32 outside the tensor
# cores, 67 TFLOP/s in f64 on the tensor cores and 495 TFLOP/s in TF32
# (NVIDIA's data sheet).  K7's f32 tensor-core path does each product as
# three TF32 products (3xTF32), so its least time for 2*m*n*k FLOP of f32
# work counts 3 * that at the TF32 rate.  The complex K1 and K2 run on the
# SIMT units: 67 TFLOP/s in f32 and 34 TFLOP/s in f64 outside the tensor
# cores (the data sheet's FP64 rate), 8 real FLOP a complex multiply-add.
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
SIMT_FLOPS = {"float32": 67e12, "float64": 34e12}
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
    traffic writes back; ``clean=True`` flushes by reading instead.

    A sleep kernel holds the stream while the host queues the timed
    launches, so that the card runs flush, event, launch, event back to back
    and no stall of the host falls between a pair of events (on a shared
    host such stalls inflated single-launch times several-fold)."""

    HOLD_CYCLES = 20_000_000   # ~10 ms at the H100's 1.98 GHz boost clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def ms(self, fn, iters=20, warmup=3, clean=False) -> float:
        torch = self.torch
        flush = self.flush.sum if clean else self.flush.zero_
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(self.HOLD_CYCLES)
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


def timed(torch, fn, reps: int) -> float:
    """CUDA-event ms per call over ``reps`` back-to-back calls, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def simt_peak(dt) -> float:
    """The SIMT peak of a torch dtype's real type (a complex row's)."""
    from hifir_tpu_torch.device import real_dtype

    return SIMT_FLOPS[str(real_dtype(dt)).removeprefix("torch.")]


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


def k1_bytes(A, nrhs: int, es: int, form: str) -> int:
    """Bytes that K1's function must move for a scipy CSR A: A's entries
    (index and value) once, the rows of X that A reads once, and the rows
    of C read and of out written: in place only the rows with entries, out
    of place every row, C not read for the plain product.  K1's row tables
    are format overhead."""
    nrows = A.shape[0]
    rows = {"in-place": 2 * int(np.count_nonzero(np.diff(A.indptr))),
            "out-of-place": 2 * nrows, "product": nrows}[form]
    return (A.nnz * (4 + es) + np.unique(A.indices).size * nrhs * es
            + rows * nrhs * es)


def sell_csr(A):
    """A SlicedELL back as a host scipy CSR, from K1's position table."""
    import scipy.sparse as sp

    order = A.order.cpu().numpy()
    counts = np.zeros(A.nrows, np.int64)
    counts[order] = A.pos_nnz.cpu().numpy()
    first = np.zeros(A.nrows, np.int64)
    first[order] = A.pos_ptr.cpu().numpy()
    indptr = np.concatenate([[0], np.cumsum(counts)])
    at = (np.repeat(first, counts) + np.arange(indptr[-1])
          - np.repeat(indptr[:-1], counts))
    return sp.csr_matrix((A.flat_values.cpu().numpy()[at],
                          A.flat_indices.cpu().numpy()[at], indptr),
                         shape=(A.nrows, A.ncols))


class Rows:
    """The kernel rows of the report: each kernel against its plain version
    on the same inputs, with the kernel's, the plain version's and the
    library call's times and the least time the card could take."""

    def __init__(self, T):
        self.T, self.rows = T, []

    def library(self, what, fn, ref, tol, optional=False):
        """Check one PyTorch call computing the same function against the
        kernel's result; return its time and difference.  ``optional``: a
        call this torch build cannot run on the card (no complex CUDA path)
        returns None with the error text instead of failing the script."""
        try:
            rel = rel_diff(fn(), ref)
        except (RuntimeError, NotImplementedError) as e:
            if not optional:
                raise
            note = str(e).strip().splitlines()[0][:200]
            log(f"  {what}: none on the card ({note})")
            return None, note
        log(f"  {what}: library call vs kernel rel diff {rel:.3e} "
            f"(tol {tol:.0e})")
        gate(rel <= tol, f"{what}: library call differs by {rel:.3e}")
        return self.T.ms(fn), rel

    def record(self, name, dtype, shape, Y, Yp, ms, plain_ms, lib, nbytes,
               flops, tol, peak=None):
        abs_err = float((Y - Yp).abs().max())
        rel = rel_diff(Y, Yp)
        bms, by = bound(nbytes, flops, dtype, peak)
        library_ms, library_rel = lib if lib else (None, None)
        note = None
        if library_ms is None and isinstance(library_rel, str):
            note, library_rel = library_rel, None
        row = dict(name=name, dtype=dtype, shape=shape, max_abs_err=abs_err,
                   rel_err=rel, tol=tol, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, library_rel_diff=library_rel,
                   library_note=note,
                   bytes=nbytes, flops=flops, bound_ms=bms, bound_by=by,
                   share_of_bound=bms / ms,
                   vs_library=None if library_ms is None else ms / library_ms)
        log(f"  {name:9s} {dtype:7s} {shape:44s} rel_err {rel:.3e} "
            f"(tol {tol:.0e})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"library {'none' if library_ms is None else f'{library_ms:.4f}'}"
            f" ms  bound {bms:.4f} ms ({by})")
        gate(rel <= tol, f"{name} {dtype} {shape}: rel err {rel:.3e} > {tol}")
        self.rows.append(row)


def randn(rng, shape, dt):
    """Seeded normal values of torch dtype ``dt`` on the card, complex with
    independent real and imaginary parts for a complex dtype."""
    import torch

    a = rng.standard_normal(shape)
    if dt.is_complex:
        a = a + 1j * rng.standard_normal(shape)
    return torch.as_tensor(a, dtype=dt, device="cuda")


def k1_row(torch, book, rng, sweeps, name, A, nrhs, form, what, dt, tol,
           sign=-1):
    """K1 on operator ``A`` in ``form`` (as its call site runs it) against
    the plain version, with the library call computing the same function;
    ``sign=1`` computes C + A X.  A complex row counts 8 real FLOP per entry
    and column against the SIMT rate of its real type."""
    from hifir_tpu_torch.ops import spmv

    dname = str(dt).removeprefix("torch.")
    es = torch.empty((), dtype=dt).element_size()
    Ah = sell_csr(A)
    X = randn(rng, (A.ncols, nrhs), dt)
    C = None if form == "product" else randn(rng, (A.nrows, nrhs), dt)
    Acsr = csr_tensor(torch, Ah, dt, "cuda")
    if form == "in-place":
        Y = C.clone()
        spmv.sliced_ell_sub_mrhs(A, X, Y, out=Y, sign=sign)
        Cw = C.clone()      # timed calls keep updating it
        run = lambda: spmv.sliced_ell_sub_mrhs(A, X, Cw, out=Cw, sign=sign)
        plain = lambda: spmv.sliced_ell_sub_mrhs_plain(A, X, Cw, out=Cw,
                                                       sign=sign)
    else:
        Y = spmv.sliced_ell_sub_mrhs(A, X, C, sign=sign)
        run = lambda: spmv.sliced_ell_sub_mrhs(A, X, C, sign=sign)
        plain = lambda: spmv.sliced_ell_sub_mrhs_plain(A, X, C, sign=sign)
    Yp = spmv.sliced_ell_sub_mrhs_plain(A, X, C, sign=sign)
    torch.cuda.synchronize()
    if form == "product":
        lib = (f"K1 {dname} {what} torch.sparse.mm",
               lambda: torch.sparse.mm(Acsr, X))
    else:
        lib = (f"K1 {dname} {what} torch.addmm(C, A, X, alpha={sign})",
               lambda: torch.addmm(C, Acsr, X, beta=1, alpha=sign))
    rows_nz = int(np.count_nonzero(np.diff(Ah.indptr)))
    shape = (f"{A.nrows}x{A.ncols} nnz={Ah.nnz} rows_nz={rows_nz} "
             f"{what} nrhs={nrhs} form={form} sign={sign:+d}")
    cplx = dt.is_complex
    book.record(name, dname, shape, Y, Yp, book.T.ms(run), book.T.ms(plain),
                book.library(lib[0], lib[1], Y, tol, optional=cplx),
                k1_bytes(Ah, nrhs, es, form),
                (8.0 if cplx else 2.0) * Ah.nnz * nrhs, tol,
                simt_peak(dt) if cplx else None)
    # the same launch after a reading flush (no dirty L2 lines)
    ms = book.T.ms(run, clean=True)
    sweeps.append(dict(what=f"{name} {shape}", dtype=dname, flush="read",
                       ms=ms))
    log(f"  {name:9s} {dname:7s} same, read flush: {ms:.4f} ms")


def k2_row(torch, book, rng, name, li, S, Th, lower, nrhs, dt, tol, stol):
    """K2 B to X on schedule ``S`` (host factor ``Th``) against the plain
    version.  The library call solving the same unit triangular system is
    torch.triangular_solve on a CSR factor (cuSPARSE SpSM), in row order
    like the kernel's B and X."""
    import scipy.sparse as sp

    from hifir_tpu_torch.ops import trsv

    dname = str(dt).removeprefix("torch.")
    es = torch.empty((), dtype=dt).element_size()
    nslots = S.nchunks * S.chunk
    Ts = Th.to_scipy().tocsr()
    Ts = (sp.tril(Ts, -1) if lower else sp.triu(Ts, 1)).tocsr()
    Tcsr = csr_tensor(torch, (Ts + sp.eye(S.n, format="csr"))
                      .tocsr().sorted_indices(), dt, "cuda")
    B = randn(rng, (S.n, nrhs), dt)
    Xk = trsv.trsv_apply_mrhs(S, B)
    Xp = trsv.trsv_apply_plain(S, B)
    torch.cuda.synchronize()
    K = S.cols.shape[2]
    cplx = dt.is_complex
    # the function's bytes: the strict factor's entries, B and X
    nbytes = Ts.nnz * (4 + es) + 2 * S.n * nrhs * es
    book.record(name, dname,
                f"level={li} slots={nslots} K={K} levels={S.nlevels} "
                f"nrhs={nrhs} x={trsv.trsv_shape(nslots, es)}",
                Xk, Xp, book.T.ms(lambda: trsv.trsv_apply_mrhs(S, B)),
                book.T.ms(lambda: trsv.trsv_apply_plain(S, B)),
                book.library(f"K2 {dname} level {li} "
                             f"{name.removeprefix('K2_trsv_')} nrhs={nrhs} "
                             "torch.triangular_solve (CSR)",
                             lambda: torch.triangular_solve(
                                 B, Tcsr, upper=not lower,
                                 unitriangular=True)[0], Xk, stol,
                             optional=cplx),
                nbytes, (8.0 if cplx else 2.0) * Ts.nnz * nrhs, tol,
                simt_peak(dt) if cplx else None)


def kernel_phases(torch, T, M, Mc, rng):
    """Each kernel against its plain version at main-path shapes (``M`` the
    frozen fixture, ``Mc`` the nonsymmetric one); returns the rows and the
    sweeps."""
    from hifir_tpu_torch.kernels.build import check, load_kernels
    from hifir_tpu_torch.models.problems import poisson2d
    from hifir_tpu_torch.ops import bsr_spmv, spmv, trsv

    book = Rows(T)
    rows, sweeps = book.rows, []
    library, record = book.library, book.record

    def sweep(what, dtype, fn, ref, tol):
        """Time a forced variant after checking it against ``ref``."""
        Y = fn()
        torch.cuda.synchronize()
        rel = rel_diff(Y, ref)
        gate(rel <= tol, f"{what} {dtype}: rel err {rel:.3e} > {tol}")
        ms = T.ms(fn)
        sweeps.append(dict(what=what, dtype=dtype, ms=ms, rel_err=rel))
        log(f"  sweep {what:48s} {dtype:7s} {ms:.4f} ms (rel err {rel:.1e})")

    # the timer's floor: a launch that reads 16 bytes (the yardstick read
    # kernel), after the writing flush and after a reading one
    lib = load_kernels().lib
    sink = torch.zeros(4, dtype=torch.int32, device="cuda")

    def launch_floor():
        check(lib.read_rate(sink.data_ptr(), 16, sink.data_ptr(), 0x9E3779B9,
                            torch.cuda.current_stream().cuda_stream),
              "read_rate")

    for clean in (False, True):
        ms = T.ms(launch_floor, clean=clean)
        flush = "read" if clean else "write"
        sweeps.append(dict(what="launch floor (16-byte read kernel)",
                           flush=flush, ms=ms))
        log(f"  launch floor: 16-byte read kernel, {flush} flush {ms:.4f} ms")

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

        def k1(name, A, nrhs, form, what, sign=-1):
            k1_row(torch, book, rng, sweeps, name, A, nrhs, form, what, dt,
                   tol, sign)

        # K1 on level 0's E (down-sweep) and F (up-sweep) in place, as the
        # M-solve runs them, and as the plain product at 128 RHS
        for nm, E in (("E", lvl.E), ("F", lvl.F)):
            for nrhs in (NRHS, 8, 1):
                k1(f"K1_sell_{nm}", E, nrhs, "in-place",
                   f"buckets={len(E.blocks)}")
            k1(f"K1_sell_{nm}", E, NRHS, "product",
               f"buckets={len(E.blocks)}")
        # the blocked inverse's heaviest Off_b of each side, in
        # _block_dense_apply's form: out of place from B's rows into the
        # scratch, in place on it when the block is short
        for nm, Th, lower, b in (("L", host.L_B, True, 6),
                                 ("U", host.U_B, False, 4)):
            bd = trsv.build_trsv_block_dense(Th, lower=lower, W=2048,
                                             dtype=npdt)
            short = bd.n - bd.starts[b] < bd.W
            for nrhs in (NRHS, 1):
                k1(f"K1_sell_{nm}off", bd.offs[b], nrhs,
                   "in-place" if short else "out-of-place",
                   f"block={b + 1}/{len(bd.starts)}")
        # K1 with sign +1, the products' z + U z: level 0's strict U_B of
        # the nonsymmetric fixture, in place
        Uell = spmv.sliced_ell_from_csr(Mc.precs[0].U_B, dtype=npdt)
        for nrhs in (NRHS, 1):
            k1("K1_sell_Uplus", Uell, nrhs, "in-place",
               f"convdiff level=0 U_B buckets={len(Uell.blocks)}", sign=1)

        # K1 on a uniform ELL (the form an ELL operator A takes in HIFIR)
        El = spmv.ell_from_csr(host.E, dtype=npdt)
        Eh = host.E.to_scipy().tocsr()
        Ecsr = csr_tensor(torch, Eh, dt, "cuda")
        X = torch.as_tensor(rng.standard_normal((El.ncols, NRHS)), dtype=dt,
                            device="cuda")
        Y = spmv.ell_matvec_mrhs(El, X)
        Yp = spmv.ell_matvec_mrhs_plain(El, X)
        torch.cuda.synchronize()
        record("K1_ell_E", dname, f"{El.nrows}x{El.ncols} K={El.k} "
               f"nrhs={NRHS} form=product", Y, Yp,
               T.ms(lambda: spmv.ell_matvec_mrhs(El, X)),
               T.ms(lambda: spmv.ell_matvec_mrhs_plain(El, X)),
               library(f"K1 {dname} uniform ELL E torch.sparse.mm",
                       lambda: torch.sparse.mm(Ecsr, X), Y, tol),
               k1_bytes(Eh, NRHS, es, "product"), 2.0 * Eh.nnz * NRHS, tol)

        # K2: B to X on both levels' L_B and U_B schedules
        stol = 1e-4 if npdt == np.float32 else 1e-10
        for li, (lv, hp) in enumerate(zip(dp.levels, M.precs)):
            for nm, S, Th, lower in (("L", lv.L, hp.L_B, True),
                                     ("U", lv.U, hp.U_B, False)):
                for nrhs in (NRHS, 1):
                    k2_row(torch, book, rng, f"K2_trsv_{nm}", li, S, Th,
                           lower, nrhs, dt, tol, stol)
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
    counters()["K1"].plus_launches = 0


def read_counts():
    return {k: f.launches for k, f in counters().items()}


def want_launches(forms) -> dict:
    """The launches one M-solve must make on a pack whose levels' operands
    are ``forms``, (L, U, E, F) per level (forward, or the adjoint's
    (L^H, U^H, F^H, E^H)): K2 once per triangular solve on a schedule, L and
    U of every such level once down and once up; K1 once per operator with
    entries, E on the way down, F on the way up, and every Off_b of a
    blocked inverse, whose L and U run once down and once up."""
    from hifir_tpu_torch.ops.trsv import TrsvBlockDense, TrsvSchedule

    k2 = 2 * sum(isinstance(f, TrsvSchedule) and f.nchunks > 0
                 for L, U, _, _ in forms for f in (L, U))
    k1 = sum((E.nnz > 0) + (F.nnz > 0) for _, _, E, F in forms)
    k1 += 2 * sum(o.nnz > 0 for L, U, _, _ in forms for f in (L, U)
                  if isinstance(f, TrsvBlockDense) for o in f.offs)
    return {"K1": k1, "K2": k2}


def prod(p, X, trans):
    """M X (``trans``: M^H X) on pack ``p`` through the module functions."""
    from hifir_tpu_torch.alg.prec import prec_prod_mrhs, prec_prod_tran_mrhs

    if trans:
        return prec_prod_tran_mrhs(p.levels, p.tran, p.prod_tran, p.tail, X)
    return prec_prod_mrhs(p.levels, p.prod, p.tail, X)


def want_plus(dp, trans) -> int:
    """K1 launches with sign +1 that one product must make: L and U of
    every level with entries, and E (F^H for the adjoint) where the level
    has tail rows."""
    if not trans:
        return sum((pl.Lell.nnz > 0) + (pl.Uell.nnz > 0)
                   + (lv.n > lv.m and lv.E.nnz > 0)
                   for lv, pl in zip(dp.levels, dp.prod))
    return sum((pt.LellH.nnz > 0) + (pt.UellH.nnz > 0)
               + (lv.n > lv.m and t.FT.nnz > 0)
               for lv, t, pt in zip(dp.levels, dp.tran, dp.prod_tran))


def main_path(torch, M, A, rng):
    """Frozen-operator M-solves and HIFIR refinement; returns launch counts,
    per-solve launches, and the packs for timing."""
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.ops.bsr_spmv import bsr_from_csr
    from hifir_tpu_torch.ops.spmv import ell_matvec_mrhs
    from hifir_tpu_torch.ops.trsv import TrsvBlockDense

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
            dp = packs[(di, np.dtype(npdt).name)] = M.to_device(
                dtype=npdt, dense_inv=di)
            # K1's row tables (order, pos_ptr, pos_nnz) of every operator
            ops = [o for lvl in dp.levels for o in (lvl.E, lvl.F)]
            ops += [o for lvl in dp.levels for f in (lvl.L, lvl.U)
                    if isinstance(f, TrsvBlockDense) for o in f.offs]
            table = sum(t.nbytes for o in ops
                        for t in (o.order, o.pos_ptr, o.pos_nnz))
            log(f"  pack dense_inv={di!s:4s} {np.dtype(npdt).name}: "
                f"{time.perf_counter() - t0:.2f} s (host); K1 tables "
                f"{table} B over {len(ops)} operators")
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
        want = want_launches([(lvl.L, lvl.U, lvl.E, lvl.F)
                              for lvl in dp.levels])
        for k, w in want.items():
            got = per_solve[f"dense_inv={di} {dt}"][k]
            gate(got == w, f"M-solve dense_inv={di} {dt}: {got} {k} "
                 f"launches, expected {w}")

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
    for k in ("bsr_mma_kernel", "bsr_stream_kernel", "sell_wide_kernel",
              "sell_narrow_kernel", "trsv_solve_kernel", "chunk_fma_kernel",
              "chunk_sweep_kernel", "schur_partial_kernel"):
        if k in name:
            return k
    return name if len(name) <= 70 else name[:67] + "..."


# seconds of idle host at each end of a profiled window.  The tracer
# (Kineto over CUPTI) drops a device record whose start, converted to the
# host clock, falls before the window opened, and one whose end falls
# after it closed; in some windows that conversion puts the whole device
# timeline milliseconds early against the launches (PERF.md section 6),
# and without a pad the first launches' records were lost.
PROFILE_PAD_S = 0.1
# a window whose K1/K2/K7 records differ from the launch counters is taken
# again, up to this many takes in all; the last take is gated
PROFILE_TAKES = 3
# every profiled window of the run: its clock offset (see profiled()) and
# whether it lost records
PROFILE_WINDOWS = []
# the host calls that queue device work
_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
             "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
             "cudaMemcpyAsync")
# the kernel names the profiler reports, by kernel
_KERNEL_OF = {"bsr_mma_kernel": "K7", "bsr_stream_kernel": "K7",
              "sell_wide_kernel": "K1", "sell_narrow_kernel": "K1",
              "trsv_solve_kernel": "K2", "chunk_fma_kernel": "K10a",
              "chunk_sweep_kernel": "sweep", "schur_partial_kernel": "K10b"}


def profiled(torch, body, warm=None, start=None, pads=None):
    """torch.profiler around one call of ``body``: an unprofiled and a
    profiled call of ``warm`` (default ``body``; the schedule discards the
    second's events), then ``PROFILE_PAD_S`` of idle host, ``start()`` if
    given, ``body``, a synchronisation and another pad before the window
    closes (``pads``, the pads after opening and before closing, default
    ``PROFILE_PAD_S`` each).  Returns the profiler and the window's clock
    offset: the least (device start - host launch) over its records,
    matched by correlation id, in ms.  The first launch after the pad
    meets an idle device, so the offset is its launch latency (a few
    microseconds) when the two clocks agree, and negative when the trace
    puts the device timeline early."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    warm = warm or body
    pad_open, pad_close = pads or (PROFILE_PAD_S, PROFILE_PAD_S)
    warm()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(pad_open)
        if start is not None:
            start()
        body()
        torch.cuda.synchronize()
        time.sleep(pad_close)
        prof.step()
    raw = prof.profiler.kineto_results.events()
    launched = {e.correlation_id(): e.start_ns() for e in raw
                if e.device_type() != DeviceType.CUDA
                and e.name() in _LAUNCHES}
    lags = [e.start_ns() - launched[e.correlation_id()] for e in raw
            if e.device_type() == DeviceType.CUDA
            and e.correlation_id() in launched]
    return prof, min(lags) / 1e6 if lags else None


def device_profile(torch, run, reps: int, reset=None, read=None) -> dict:
    """torch.profiler over ``reps`` runs of ``run`` (:func:`profiled`):
    device time and operations per run, the host's synchronisations per
    run, and the eight largest device items by name.  The launches of K1,
    K2 and K7 that the trace holds are gated equal to their launch counters
    over the same runs, so that a trace that lost kernel records fails the
    run instead of under-reporting; a window that lost some is taken again
    (``PROFILE_TAKES``), and every take is logged with its clock offset.
    ``reset``/``read`` replace the counters' reset and read (the
    distribution phase's take K10a and K10b too)."""
    from torch.autograd import DeviceType

    reset, read = reset or reset_counts, read or read_counts

    def body():
        for _ in range(reps):
            run()

    for take in range(1, PROFILE_TAKES + 1):
        prof, offset = profiled(torch, body, warm=run, start=reset)
        counted = read()
        events = prof.events()
        # the warm-up's closing synchronisation may fall inside the window:
        # count those after the window's first launch
        first = min((ev.time_range.start for ev in events
                     if ev.name in _LAUNCHES), default=0)
        by, syncs, seen = {}, 0, dict.fromkeys(counted, 0)
        for ev in events:
            if ev.device_type != DeviceType.CUDA:
                syncs += (ev.name in ("cudaStreamSynchronize",
                                      "cudaDeviceSynchronize")
                          and ev.time_range.start > first)
                continue
            if ev.name.startswith("ProfilerStep"):
                continue    # the schedule's step range, not device work
            name = _kernel_name(ev.name)
            if name in _KERNEL_OF:
                seen[_KERNEL_OF[name]] += 1
            us, cnt = by.get(name, (0.0, 0))
            by[name] = (us + ev.time_range.elapsed_us(), cnt + 1)
        PROFILE_WINDOWS.append(dict(offset_ms=offset, take=take,
                                    lost=seen != counted))
        if seen == counted:
            break
        log(f"  profiler take {take}: saw {seen} of {counted} launches, "
            f"clock offset {offset} ms")
    for k, c in counted.items():
        gate(seen[k] == c, f"the profiler saw {seen[k]} {k} launches, the "
             f"launch counter {c}")
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(
        device_ms_per_run=sum(us for us, _ in by.values()) / reps / 1e3,
        device_ops_per_run=sum(c for _, c in by.values()) / reps,
        host_syncs_per_run=(syncs - 1) / reps,   # less the closing one
        launches_per_run={k: c / reps for k, c in counted.items()},
        clock_offset_ms=offset, takes=take,
        top=[dict(name=n, ms_per_run=us / reps / 1e3,
                  count_per_run=c / reps) for n, (us, c) in top])


def profile_probe(torch, seconds: float, out_dir=None) -> dict:
    """How often a profiled window loses device records, by pad: windows of
    5 adjoint `auto` f32 solves on the nonsymmetric fixture (the cell that
    lost records in PR 5 and PR 6), interleaved with no pad, a pad after
    opening only, and a pad at both ends, for ``seconds``.  Each window
    keeps its K1 counts (trace and counter) and its clock offset."""
    import hifir_tpu_torch as ht

    M = ht.load_prec(CONVDIFF)
    dp = M.to_device(dtype=np.float32, dense_inv="auto")
    dp.pack_transpose(M.precs)
    B = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (M.precs[0].n, NRHS)), dtype=torch.float32, device="cuda")

    def run():
        dp.solve_mrhs(B, trans=True)

    def body():
        for _ in range(5):
            run()

    pads = {"none": (0.0, 0.0), "open": (PROFILE_PAD_S, 0.0),
            "both": (PROFILE_PAD_S, PROFILE_PAD_S)}
    rows, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for kind in ("none", "open", "both", "both"):
            prof, offset = profiled(torch, body, warm=run, start=reset_counts,
                                   pads=pads[kind])
            seen = sum(1 for ev in prof.events()
                       if _kernel_name(ev.name) in ("sell_wide_kernel",
                                                    "sell_narrow_kernel"))
            rows.append(dict(kind=kind, k1_seen=seen,
                             k1_counted=read_counts()["K1"],
                             offset_ms=offset))
    out = {}
    for kind in pads:
        rs = [r for r in rows if r["kind"] == kind]
        off = [r["offset_ms"] for r in rs if r["offset_ms"] is not None]
        out[kind] = dict(
            windows=len(rs),
            lost=sum(r["k1_seen"] != r["k1_counted"] for r in rs),
            k1_seen_when_lost=[r["k1_seen"] for r in rs
                               if r["k1_seen"] != r["k1_counted"]],
            offset_below_0=sum(x < 0 for x in off),
            offset_below_1ms_early=sum(x < -1.0 for x in off),
            least_offset_ms=min(off, default=None),
            largest_offset_ms=max(off, default=None))
        log(f"  pad {kind}: {json.dumps(out[kind])}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "profile_probe.json"), "w") as f:
            json.dump(dict(summary=out, windows=rows), f)
    return out


def log_profile(key: str, p: dict, wall_ms: float) -> None:
    busy = p["device_ms_per_run"]
    p["busy_share"] = busy / wall_ms if busy else None
    if not busy:
        log(f"  {key}: the profiler saw no device time (not measured)")
        return
    log(f"  {key}: device busy {busy:.4f} of {wall_ms:.4f} ms/run "
        f"({100 * busy / wall_ms:.1f}%), {p['device_ops_per_run']:.0f} "
        f"device ops/run, {p['host_syncs_per_run']:.0f} host syncs/run")
    for t in p["top"]:
        log(f"    {t['ms_per_run']:.4f} ms  x{t['count_per_run']:.0f}"
            f"  {t['name']}")


def profile_phase(torch, packs, Bd, Ab, timing, reps=5):
    """Where the time goes in the f32 M-solves and the f64 HIFIR apply:
    device time by kernel from torch.profiler over ``reps`` runs, and the
    device's busy share of the unprofiled time per run measured above."""
    import hifir_tpu_torch as ht

    runs = {f"dense_inv={di} float32": (
        lambda dp=packs[(di, "float32")]: dp.solve_mrhs(Bd["float32"]))
        for di in ("auto", 0)}
    runs["hifir_nirs4_bsr_f64"] = lambda: ht.ir_apply(
        Ab, packs[("auto", "float64")], Bd["float64"], 4)
    out = {}
    for key, run in runs.items():
        out[key] = device_profile(torch, run, reps)
        log_profile(key, out[key], timing[key].get("ms_per_solve")
                    or timing[key]["ms_per_apply"])
    return out


def surface_phase(torch, M, A, rng):
    """The rest of the preconditioner's surface on the nonsymmetric fixture
    ``M`` with its operator ``A``: the adjoint M-solve, the runtime rank, the
    null-space filter, the products M X and M^H X and the three GMRES
    drivers, each against the port's plain f64 CPU run or a check that needs
    no reference.  Every part runs with the launch counts set to 0 just
    before it and read just after; returns the report, the packs and the
    launches of each part with what each must be."""
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.ops.bsr_spmv import bsr_from_csr
    from hifir_tpu_torch.ops.spmv import sell_spmv_cuda, sliced_ell_from_csr

    launches, want = {}, {}

    def counted(what, fn):
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[what] = dict(read_counts(),
                              K1plus=sell_spmv_cuda.plus_launches)
        return out

    def rel(X, ref) -> float:
        X = X.double().cpu().numpy() if torch.is_tensor(X) else X
        ref = ref.double().numpy() if torch.is_tensor(ref) else ref
        return float(np.abs(X - ref).max() / np.abs(ref).max())

    n = A.nrows
    rank = M.precs[-1].dense_solver.rank
    B = rng.standard_normal((n, NRHS))
    report = {}
    # the references: the port's plain f64 CPU runs, level-scan form
    cpu = M.to_device(dtype=np.float64, device="cpu", dense_inv=0)
    cpu.pack_transpose(M.precs)
    ref = {t: cpu.solve_mrhs(B, trans=t).numpy() for t in (False, True)}

    # 1. the adjoint M-solve (and the forward one beside it) on every pack
    packs = {}
    for di in ("auto", 0):
        for npdt in (np.float32, np.float64):
            t0 = time.perf_counter()
            dp = M.to_device(dtype=npdt, dense_inv=di, device="cuda")
            dp.pack_transpose(M.precs)
            packs[(di, np.dtype(npdt).name)] = dp
            log(f"  pack + pack_transpose dense_inv={di!s:4s} "
                f"{np.dtype(npdt).name}: {time.perf_counter() - t0:.2f} s")
    Bd = {dt: torch.as_tensor(B, dtype=getattr(torch, dt), device="cuda")
          for dt in ("float32", "float64")}
    for (di, dt), dp in packs.items():
        for trans in (True, False):
            key = f"{'adjoint' if trans else 'forward'} dense_inv={di} {dt}"
            X = counted(key, lambda: dp.solve_mrhs(Bd[dt], trans=trans))
            gate(bool(torch.isfinite(X).all()), f"{key}: non-finite")
            gate(tuple(X.shape) == (n, NRHS), f"{key}: shape")
            tol = 1e-4 if dt == "float32" else 1e-10
            d = rel(X, ref[trans])
            forms = ([(t.LT, t.UT, t.FT, t.ET) for t in dp.tran] if trans
                     else [(lv.L, lv.U, lv.E, lv.F) for lv in dp.levels])
            want[key] = want_launches(forms)
            report[key] = dict(rel_diff=d, tol=tol)
            log(f"  M-solve {key:30s}: rel diff vs CPU f64 {d:.3e} "
                f"(tol {tol:.0e}); launches {launches[key]}")
            gate(d <= tol, f"{key}: {d:.3e} > {tol}")
    # <Y, M^{-1} X> = <M^{-H} Y, X> for every column pair, in f64
    Y = torch.as_tensor(rng.standard_normal((n, NRHS)), dtype=torch.float64,
                        device="cuda")
    for di in ("auto", 0):
        dp = packs[(di, "float64")]
        MX = dp.solve_mrhs(Bd["float64"])
        lhs = Y.T @ MX
        rhs = dp.solve_mrhs(Y, trans=True).T @ Bd["float64"]
        scale = (torch.linalg.vector_norm(Y, dim=0)[:, None]
                 * torch.linalg.vector_norm(MX, dim=0)[None, :])
        worst = float(((lhs - rhs).abs() / scale).max())
        report[f"adjoint identity dense_inv={di}"] = worst
        log(f"  adjoint identity dense_inv={di!s:4s} f64: max |<Y, M^-1 X> - "
            f"<M^-H Y, X>| / (|Y| |M^-1 X|) = {worst:.3e} (tol 1e-10)")
        gate(worst <= 1e-10, f"adjoint identity dense_inv={di}: {worst:.3e}")

    # 2. the runtime rank, f64, forward and adjoint, on 8 columns
    dp = packs[("auto", "float64")]
    B8 = Bd["float64"][:, :8]
    r = round(0.75 * rank)
    for trans in (False, True):
        side = "adjoint" if trans else "forward"
        X = dp.solve_mrhs(B8, trans=trans)
        d_full = rel(dp.solve_mrhs(B8, trans=trans, r=rank), X.cpu())
        Xr = dp.solve_mrhs(B8, trans=trans, r=r)
        d_trunc = rel(Xr, cpu.solve_mrhs(B[:, :8], trans=trans, r=r))
        moved = rel(Xr, X.cpu())
        report[f"rank {side}"] = dict(r_full=rank, full_vs_static=d_full,
                                      r=r, vs_cpu=d_trunc, moved=moved)
        log(f"  rank {side}: r={rank} vs the pack's rank {d_full:.3e} "
            f"(tol 1e-12); r={r} vs CPU {d_trunc:.3e} (tol 1e-10), "
            f"vs the full rank {moved:.3e}")
        gate(d_full <= 1e-12, f"rank {side}: r=rank differs by {d_full:.3e}")
        gate(d_trunc <= 1e-10, f"rank {side}: r={r} vs CPU {d_trunc:.3e}")
        gate(moved > 1e-8, f"rank {side}: r={r} changed nothing")

    # 3. the constant-mode null-space filter on every column
    dp.nsp, dp.nsp_tran = ht.NspFilter(), ht.NspFilter()
    for trans in (False, True):
        X = dp.solve_mrhs(Bd["float64"], trans=trans)
        worst = float(X.mean(dim=0).abs().max() / X.abs().max())
        report[f"nsp {'adjoint' if trans else 'forward'}"] = worst
        log(f"  nsp {'adjoint' if trans else 'forward'}: max |column mean| "
            f"/ max|X| = {worst:.3e} (tol 1e-12)")
        gate(worst <= 1e-12, f"nsp: column mean {worst:.3e}")
    dp.nsp = dp.nsp_tran = None

    # 4. the products through the module functions, 8 and NRHS columns
    dp.pack_prod(M.precs)
    dp.pack_prod_tran(M.precs)
    cpu.pack_prod(M.precs)
    cpu.pack_prod_tran(M.precs)

    for k in (8, NRHS):
        Xk = Bd["float64"][:, :k].contiguous()
        for trans in (False, True):
            key = f"mmultiply{' adjoint' if trans else ''} {k} columns"
            Yk = counted(key, lambda: prod(dp, Xk, trans))
            d = rel(Yk, prod(cpu, torch.as_tensor(B[:, :k]), trans))
            want[key] = {"K1plus": want_plus(dp, trans)}
            report[key] = dict(rel_diff=d)
            log(f"  {key}: rel diff vs CPU f64 {d:.3e} (tol 1e-10); "
                f"launches {launches[key]}")
            gate(d <= 1e-10, f"{key}: {d:.3e} > 1e-10")
    for trans in (False, True):
        Bt = Bd["float64"]
        err = float(torch.linalg.norm(
            prod(dp, dp.solve_mrhs(Bt, trans=trans), trans) - Bt)
            / torch.linalg.norm(Bt))
        side = "M^H (M^-H B)" if trans else "M (M^-1 B)"
        report[f"{side} - B"] = err
        log(f"  ||{side} - B|| / ||B|| = {err:.3e} (tol 1e-9)")
        gate(err <= 1e-9, f"{side} - B: {err:.3e}")

    # 5. the GMRES drivers, f64, against the plain CPU runs of the same
    # pack form; true residuals on the host from the CSR A
    Ah = A.to_scipy()
    cpu_auto = M.to_device(dtype=np.float64, device="cpu")
    ops = {"sell": (sliced_ell_from_csr(A, device="cuda"),
                    sliced_ell_from_csr(A, device="cpu")),
           "bsr": (bsr_from_csr(A, bs=128, device="cuda"),
                   bsr_from_csr(A, bs=128, device="cpu"))}
    rtol = 1e-6
    drivers = {
        "gmres_hif": ("sell", lambda Ao, p: ht.gmres_hif(Ao, p, B[:, 0],
                                                         rtol=rtol)),
        "fgmres_hifir": ("sell", lambda Ao, p: ht.fgmres_hifir(
            Ao, p, B[:, 0], rtol=rtol, rank=rank)),
        "gmres_mrhs": ("bsr", lambda Ao, p: ht.gmres_mrhs(Ao, p, B,
                                                          rtol=rtol)),
    }
    for name, (op, drive) in drivers.items():
        t0 = time.perf_counter()
        x, flag, it = counted(name, lambda: drive(ops[op][0], dp))
        seconds = time.perf_counter() - t0
        _, flag_c, it_c = drive(ops[op][1], cpu_auto)
        X = x.cpu().numpy().reshape(n, -1)
        Bk = B[:, :X.shape[1]]
        res = np.linalg.norm(Bk - Ah @ X, axis=0) / np.linalg.norm(Bk, axis=0)
        what = "cycles" if name == "gmres_mrhs" else "iterations"
        report[name] = dict(flag=flag, count=it, cpu_count=it_c,
                            cpu_flag=flag_c, what=what,
                            max_true_rel_residual=float(res.max()),
                            first_run_seconds=seconds)
        log(f"  {name} ({op} A, {X.shape[1]} RHS): flag {flag}, {it} {what} "
            f"(CPU plain run: flag {flag_c}, {it_c}), max true relative "
            f"residual {res.max():.3e} (tol {1.01 * rtol:.2e}); first run "
            f"{seconds:.3f} s; launches {launches[name]}")
        gate(flag == 0, f"{name}: flag {flag}")
        gate(float(res.max()) <= 1.01 * rtol, f"{name}: residual "
             f"{res.max():.3e}")
        gate(abs(it - it_c) <= 1, f"{name}: {it} {what} against the CPU "
             f"run's {it_c}")
        if it != it_c:
            log(f"  {name}: one {what[:-1]} apart from the CPU run: the "
                "card's and the CPU's sums round differently, and the last "
                "residual estimate sits at rtol")
        want[name] = {"K7": 1} if op == "bsr" else {}
    return report, packs, launches, want, ops, B


def check_surface_launches(launches, want):
    """Gate each part's launches: exactly what the M-solves and products
    must make, and at least one K7 launch in the batched GMRES (its
    A-products)."""
    for key, w in want.items():
        got = launches[key]
        for k, v in w.items():
            ok = got[k] >= v if k == "K7" else got[k] == v
            gate(ok, f"{key}: {got[k]} {k} launches, expected "
                 f"{'at least ' if k == 'K7' else ''}{v}")
    total = {k: sum(c[k] for c in launches.values())
             for k in ("K7", "K1", "K2", "K1plus")}
    for k, c in total.items():
        gate(c > 0, f"kernel {k} was not launched on the surface path")
    return total


def time_surface(torch, packs, ops, M, B):
    """Card times of the surface on the right-hand sides ``B`` that its
    gates used: the adjoint and forward M-solves (``CHAIN`` back-to-back,
    CUDA events), the products (20 back-to-back), each GMRES driver's time
    to solution (host clock, synchronised) and peak memory, and
    torch.profiler breakdowns of the f32 adjoint solves, the 128-column
    products and each driver's solve."""
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.alg.prec import prec_prod_mrhs, prec_prod_tran_mrhs

    out, runs = {}, {}
    Bd = {dt: torch.as_tensor(B, dtype=getattr(torch, dt), device="cuda")
          for dt in ("float32", "float64")}
    for (di, dt), dp in packs.items():
        for trans in (True, False):
            key = f"{'adjoint' if trans else 'forward'} dense_inv={di} {dt}"
            run = runs[key] = (lambda dp=dp, dt=dt, trans=trans:
                               dp.solve_mrhs(Bd[dt], trans=trans))
            ms = timed(torch, run, CHAIN)
            out[key] = dict(ms=ms, us_per_rhs=ms * 1e3 / NRHS)
            log(f"  {key:30s}: {ms:.4f} ms/solve, {ms * 1e3 / NRHS:.4f} "
                "us/RHS")
    dp = packs[("auto", "float64")]
    for k in (8, NRHS):
        Xk = Bd["float64"][:, :k].contiguous()
        for trans in (False, True):
            key = f"mmultiply{' adjoint' if trans else ''} {k} columns f64"
            run = runs[key] = (
                (lambda Xk=Xk: prec_prod_tran_mrhs(
                    dp.levels, dp.tran, dp.prod_tran, dp.tail, Xk)) if trans
                else (lambda Xk=Xk: prec_prod_mrhs(dp.levels, dp.prod,
                                                   dp.tail, Xk)))
            ms = timed(torch, run, 20)
            out[key] = dict(ms=ms)
            log(f"  {key:33s}: {ms:.4f} ms")
    rank = M.precs[-1].dense_solver.rank
    drivers = {
        "gmres_hif": lambda: ht.gmres_hif(ops["sell"][0], dp, B[:, 0]),
        "fgmres_hifir": lambda: ht.fgmres_hifir(ops["sell"][0], dp, B[:, 0],
                                                rank=rank),
        "gmres_mrhs": lambda: ht.gmres_mrhs(ops["bsr"][0], dp, B),
    }
    for name, run in drivers.items():
        runs[name] = run
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        _, _, count = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        out[name] = dict(ms=ms, count=count, peak_bytes=peak,
                         peak_bytes_above_packs=peak - base)
        log(f"  {name:12s}: {ms:.2f} ms to solution ({count} "
            f"{'cycles' if name == 'gmres_mrhs' else 'iterations'}); peak "
            f"memory {peak / 2**20:.1f} MiB, {(peak - base) / 2**20:.1f} MiB "
            "above the packs")
    log("  where the time goes (torch.profiler):")
    profiles = {}
    for key in ("adjoint dense_inv=auto float32", "adjoint dense_inv=0 "
                "float32", f"mmultiply {NRHS} columns f64",
                f"mmultiply adjoint {NRHS} columns f64", *drivers):
        reps = 1 if key in drivers else 5
        profiles[key] = device_profile(torch, runs[key], reps)
        log_profile(key, profiles[key], out[key]["ms"])
    return out, profiles


CPLX = ("complex64", "complex128")


def plain_calls() -> int:
    """Calls of the plain kernel versions so far (every dispatch the CPU
    path made, and every comparison against a plain version)."""
    from hifir_tpu_torch.ops import bsr_spmv, spmv, trsv

    return (spmv.sliced_ell_sub_mrhs_plain.calls
            + trsv.trsv_apply_plain.calls
            + bsr_spmv.bsr_matvec_mrhs_plain.calls)


def complex_phase(torch, T, M, A, rng):
    """complex64 and complex128 through the port's surface on the complex
    nonsymmetric fixture ``M`` with its operator ``A``: the complex K1 and
    K2 rows against their plain versions, forward and adjoint M-solves on
    packs dense_inv "auto" and 0, the adjoint identity (and the failure of
    the unconjugated pairing), the runtime rank, the products both ways and
    the three GMRES drivers on a sliced-ELL A, each part with the launch
    counts and the plain-version calls set to 0 just before it and read
    just after, each reference the port's plain c128 CPU run."""
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.ops.spmv import sell_spmv_cuda, sliced_ell_from_csr

    launches, want, plain = {}, {}, {}

    def counted(what, fn):
        torch.cuda.synchronize()
        reset_counts()
        p0 = plain_calls()
        out = fn()
        torch.cuda.synchronize()
        launches[what] = dict(read_counts(),
                              K1plus=sell_spmv_cuda.plus_launches)
        plain[what] = plain_calls() - p0
        return out

    def values(a):
        return a.cpu().resolve_conj().numpy() if torch.is_tensor(a) else a

    def rel(X, ref) -> float:
        X, ref = (values(a).astype(np.complex128) for a in (X, ref))
        return float(np.abs(X - ref).max() / np.abs(ref).max())

    n = A.nrows
    rank = M.precs[-1].dense_solver.rank
    B = rng.standard_normal((n, NRHS)) + 1j * rng.standard_normal((n, NRHS))
    report = {}
    # the references: the port's plain c128 CPU runs, level-scan form
    cpu = M.to_device(dtype=np.complex128, device="cpu", dense_inv=0)
    cpu.pack_transpose(M.precs)
    ref = {t: cpu.solve_mrhs(B, trans=t).numpy() for t in (False, True)}
    packs = {}
    for di in ("auto", 0):
        for dt in CPLX:
            t0 = time.perf_counter()
            dp = M.to_device(dtype=np.dtype(dt), dense_inv=di, device="cuda")
            dp.pack_transpose(M.precs)
            packs[(di, dt)] = dp
            log(f"  pack + pack_transpose dense_inv={di!s:4s} {dt}: "
                f"{time.perf_counter() - t0:.2f} s")
    Bd = {dt: torch.as_tensor(B, dtype=getattr(torch, dt), device="cuda")
          for dt in CPLX}

    # 1. the complex kernel rows: K1 on level 0's E in place at 128, 8 and
    # 1 RHS and on its strict U_B with sign +1 at 128; K2 on level 0's L_B
    # schedule (the dense_inv=0 pack) at 128 and 1
    book, sweeps = Rows(T), []
    for dt in CPLX:
        tdt = getattr(torch, dt)
        tol = 1e-5 if dt == "complex64" else 1e-12
        stol = 1e-4 if dt == "complex64" else 1e-10
        lvl = packs[(0, dt)].levels[0]
        for nrhs in (NRHS, 8, 1):
            k1_row(torch, book, rng, sweeps, "K1_sell_E", lvl.E, nrhs,
                   "in-place", f"complex level=0 buckets={len(lvl.E.blocks)}",
                   tdt, tol)
        Uell = sliced_ell_from_csr(M.precs[0].U_B, dtype=np.dtype(dt))
        k1_row(torch, book, rng, sweeps, "K1_sell_Uplus", Uell, NRHS,
               "in-place", f"complex level=0 U_B buckets={len(Uell.blocks)}",
               tdt, tol, sign=1)
        for nrhs in (NRHS, 1):
            k2_row(torch, book, rng, "K2_trsv_L", 0, lvl.L, M.precs[0].L_B,
                   True, nrhs, tdt, tol, stol)

    # 2. forward and adjoint M-solves on every pack
    for (di, dt), dp in packs.items():
        for trans in (False, True):
            key = f"{'adjoint' if trans else 'forward'} dense_inv={di} {dt}"
            X = counted(key, lambda: dp.solve_mrhs(Bd[dt], trans=trans))
            gate(bool(torch.isfinite(torch.view_as_real(X)).all()),
                 f"{key}: non-finite")
            gate(tuple(X.shape) == (n, NRHS) and X.dtype == dp.dtype,
                 f"{key}: shape or dtype")
            tol = 1e-4 if dt == "complex64" else 1e-10
            d = rel(X, ref[trans])
            forms = ([(t.LT, t.UT, t.FT, t.ET) for t in dp.tran] if trans
                     else [(lv.L, lv.U, lv.E, lv.F) for lv in dp.levels])
            want[key] = want_launches(forms)
            report[key] = dict(rel_diff=d, tol=tol)
            log(f"  M-solve {key:32s}: rel diff vs CPU c128 {d:.3e} (tol "
                f"{tol:.0e}); launches {launches[key]} (want {want[key]})")
            gate(d <= tol, f"{key}: {d:.3e} > {tol}")
    # <Y, M^-1 X> = <M^-H Y, X> (<a, b> = a^H b) for every column pair, and
    # the pairing with M^-T Y, which an adjoint that dropped the conjugate
    # would give, fails
    Y = torch.as_tensor(rng.standard_normal((n, NRHS))
                        + 1j * rng.standard_normal((n, NRHS)),
                        dtype=torch.complex128, device="cuda")
    X = Bd["complex128"]
    for di in ("auto", 0):
        dp = packs[(di, "complex128")]

        def pairing(Z, MX):
            scale = (torch.linalg.vector_norm(Y, dim=0)[:, None]
                     * torch.linalg.vector_norm(MX, dim=0)[None, :])
            return float(((Y.mH @ MX - Z.mH @ X).abs() / scale).max())

        key = f"adjoint identity dense_inv={di} complex128"
        MX, MHY, MTY = counted(key, lambda: (
            dp.solve_mrhs(X), dp.solve_mrhs(Y, trans=True),
            dp.solve_mrhs(Y.conj(), trans=True).conj()))
        worst, worst_t = pairing(MHY, MX), pairing(MTY, MX)
        report[key] = dict(conjugated=worst, unconjugated=worst_t)
        log(f"  {key}: max |<Y, M^-1 X> - <M^-H Y, X>| / (|Y| |M^-1 X|) = "
            f"{worst:.3e} (tol 1e-10); with M^-T Y {worst_t:.3e} (must "
            "exceed 1e-3)")
        gate(worst <= 1e-10, f"{key}: {worst:.3e}")
        gate(worst_t > 1e-3, f"{key}: the unconjugated pairing held "
             f"({worst_t:.3e}): the fixture cannot catch a lost conjugate")

    # 3. the runtime rank, forward and adjoint, on 8 columns
    dp = packs[("auto", "complex128")]
    B8 = Bd["complex128"][:, :8]
    r = round(0.75 * rank)
    for trans in (False, True):
        side = "adjoint" if trans else "forward"
        key = f"rank {side} complex128"
        X, Xfull, Xr = counted(key, lambda: (
            dp.solve_mrhs(B8, trans=trans),
            dp.solve_mrhs(B8, trans=trans, r=rank),
            dp.solve_mrhs(B8, trans=trans, r=r)))
        d_full = rel(Xfull, X)
        d_trunc = rel(Xr, cpu.solve_mrhs(B[:, :8], trans=trans, r=r))
        moved = rel(Xr, X)
        report[key] = dict(r_full=rank, full_vs_static=d_full, r=r,
                           vs_cpu=d_trunc, moved=moved)
        log(f"  {key}: r={rank} vs the pack's rank {d_full:.3e} (tol "
            f"1e-12); r={r} vs CPU {d_trunc:.3e} (tol 1e-10), vs the full "
            f"rank {moved:.3e}")
        gate(d_full <= 1e-12, f"{key}: r=rank differs by {d_full:.3e}")
        gate(d_trunc <= 1e-10, f"{key}: r={r} vs CPU {d_trunc:.3e}")
        gate(moved > 1e-8, f"{key}: r={r} changed nothing")

    # 4. the products both ways on 8 and NRHS columns
    dp.pack_prod(M.precs)
    dp.pack_prod_tran(M.precs)
    cpu.pack_prod(M.precs)
    cpu.pack_prod_tran(M.precs)

    for k in (8, NRHS):
        Xk = Bd["complex128"][:, :k].contiguous()
        for trans in (False, True):
            key = f"mmultiply{' adjoint' if trans else ''} {k} complex128"
            Yk = counted(key, lambda: prod(dp, Xk, trans))
            d = rel(Yk, prod(cpu, torch.as_tensor(B[:, :k]), trans))
            want[key] = {"K1plus": want_plus(dp, trans)}
            report[key] = dict(rel_diff=d)
            log(f"  {key}: rel diff vs CPU c128 {d:.3e} (tol 1e-10); "
                f"launches {launches[key]}")
            gate(d <= 1e-10, f"{key}: {d:.3e} > 1e-10")
    for trans in (False, True):
        Bt = Bd["complex128"]
        key = f"M{'^H' if trans else ''} (M^-{'H' if trans else '1'}) B - B"
        err = counted(key + " complex128", lambda: float(torch.linalg.norm(
            prod(dp, dp.solve_mrhs(Bt, trans=trans), trans) - Bt)
            / torch.linalg.norm(Bt)))
        report[key] = err
        log(f"  ||{key}|| / ||B|| = {err:.3e} (tol 1e-9)")
        gate(err <= 1e-9, f"{key}: {err:.3e}")

    # 5. the GMRES drivers, c128, with a sliced-ELL A (K1 only), against the
    # plain CPU runs; true residuals on the host from the CSR A
    Ah = A.to_scipy()
    cpu_auto = M.to_device(dtype=np.complex128, device="cpu")
    ops = (sliced_ell_from_csr(A, device="cuda"),
           sliced_ell_from_csr(A, device="cpu"))
    rtol, restart = 1e-6, 10
    drivers = {
        "gmres_hif": lambda Ao, p: ht.gmres_hif(Ao, p, B[:, 0], rtol=rtol,
                                                restart=restart),
        "fgmres_hifir": lambda Ao, p: ht.fgmres_hifir(
            Ao, p, B[:, 0], rtol=rtol, restart=restart, rank=rank),
        "gmres_mrhs": lambda Ao, p: ht.gmres_mrhs(Ao, p, B, rtol=rtol,
                                                  restart=restart),
    }
    for name, drive in drivers.items():
        key = f"{name} complex128"
        t0 = time.perf_counter()
        x, flag, it = counted(key, lambda: drive(ops[0], dp))
        seconds = time.perf_counter() - t0
        _, flag_c, it_c = drive(ops[1], cpu_auto)
        X = x.cpu().numpy().reshape(n, -1)
        Bk = B[:, :X.shape[1]]
        res = np.linalg.norm(Bk - Ah @ X, axis=0) / np.linalg.norm(Bk, axis=0)
        what = "cycles" if name == "gmres_mrhs" else "iterations"
        report[key] = dict(flag=flag, count=it, cpu_count=it_c,
                           cpu_flag=flag_c, what=what, restart=restart,
                           max_true_rel_residual=float(res.max()),
                           first_run_seconds=seconds)
        log(f"  {key} (sliced-ELL A, {X.shape[1]} RHS, restart {restart}): "
            f"flag {flag}, {it} {what} (CPU plain run: flag {flag_c}, "
            f"{it_c}), max true relative residual {res.max():.3e} (tol "
            f"{1.01 * rtol:.2e}); first run {seconds:.3f} s; launches "
            f"{launches[key]}")
        gate(flag == 0, f"{key}: flag {flag}")
        gate(float(res.max()) <= 1.01 * rtol, f"{key}: residual "
             f"{res.max():.3e}")
        gate(abs(it - it_c) <= 1, f"{key}: {it} {what} against the CPU "
             f"run's {it_c}")
    return report, book.rows, sweeps, packs, launches, want, plain, Bd


def check_complex_launches(launches, want, plain):
    """Gate each complex part: the M-solves' K1 and K2 launches and the
    products' sign=+1 launches exactly, no K7 (complex A goes as sliced
    ELL), no call of a plain version on the card; K1 and K2 launched in
    each dtype.  Returns the launches of each kernel by dtype."""
    for key, w in want.items():
        for k, v in w.items():
            got = launches[key][k]
            gate(got == v, f"{key}: {got} {k} launches, expected {v}")
    for key, c in launches.items():
        gate(c["K7"] == 0, f"{key}: {c['K7']} K7 launches on a complex part")
        gate(plain[key] == 0, f"{key}: {plain[key]} plain-version calls "
             "on the card")
    by_dtype = {dt: {k: sum(c[k] for key, c in launches.items()
                            if key.endswith(dt))
                     for k in ("K1", "K2", "K1plus")} for dt in CPLX}
    for dt, c in by_dtype.items():
        for k in ("K1", "K2"):
            gate(c[k] > 0, f"kernel {k} was not launched in {dt}")
    log(f"  plain-version calls in the complex parts: "
        f"{sum(plain.values())} (must be 0)")
    return by_dtype


def time_complex(torch, packs, Bd, reps=CHAIN):
    """``reps`` back-to-back forward M-solves of the 128 complex columns per
    pack (CUDA events) and a torch.profiler breakdown of each pack's
    solve."""
    out, profiles, runs = {}, {}, {}
    for (di, dt), dp in packs.items():
        key = f"forward dense_inv={di} {dt}"
        run = runs[key] = lambda dp=dp, dt=dt: dp.solve_mrhs(Bd[dt])
        ms = timed(torch, run, reps)
        out[key] = dict(ms=ms, us_per_rhs=ms * 1e3 / NRHS, reps=reps)
        log(f"  {key:32s}: {ms:.4f} ms/solve, {ms * 1e3 / NRHS:.4f} us/RHS")
    log("  where the time goes (torch.profiler):")
    for key, run in runs.items():
        profiles[key] = device_profile(torch, run, 5)
        log_profile(key, profiles[key], out[key]["ms"])
    return out, profiles


# options of the checked-in nonsymmetric fixture (the command that wrote it
# is in tests/test_torch_surface.py) and of bench.py's poisson2d(256) leg
FIXTURE_OPTS = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=3,
                    kappa_d=3, dense_thres=600, verbose=0)
BENCH_OPTS = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5,
                  kappa_d=5, verbose=0)


def cpu_model() -> str:
    """The host CPU: its model name from /proc/cpuinfo, the machine type
    and the cores this process may use."""
    import platform

    name = "model not reported"
    try:
        with open("/proc/cpuinfo") as f:
            name = next((ln.split(":", 1)[1].strip() for ln in f
                         if ln.startswith("model name")), name)
    except OSError:
        pass
    return (f"{name}, {platform.machine()}, "
            f"{len(os.sched_getaffinity(0))} cores")


def levels_equal(P, R) -> float:
    """Gate the port's factorization ``P`` equal to the reference ``R``
    level by level, as tests/test_torch_factorize.py does: sizes,
    permutations and patterns exactly, values within 1e-12 of their largest
    magnitude, the tail's kind and rank; returns the largest relative
    value difference."""
    gate([(p.m, p.n) for p in P.precs] == [(p.m, p.n) for p in R.precs],
         "factorize: level sizes differ from the reference")
    worst = 0.0

    def close(a, b, what):
        nonlocal worst
        a, b = np.asarray(a), np.asarray(b)
        gate(a.shape == b.shape and a.dtype == b.dtype, f"{what}: shape")
        if a.size:
            d = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
            worst = max(worst, d)
            gate(d <= 1e-12, f"{what}: rel diff {d:.3e} > 1e-12")

    for i, (pp, rp) in enumerate(zip(P.precs, R.precs)):
        for f in ("p", "q", "p_inv", "q_inv"):
            gate(np.array_equal(getattr(pp, f), getattr(rp, f)),
                 f"level {i} {f} differs")
        for f in ("L_B", "U_B", "E", "F"):
            a, b = getattr(pp, f), getattr(rp, f)
            gate(a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
                 and np.array_equal(a.indices, b.indices),
                 f"level {i} {f}: pattern differs")
            close(a.data, b.data, f"level {i} {f}")
        for f in ("d", "s", "t"):
            close(getattr(pp, f), getattr(rp, f), f"level {i} {f}")
    pl, rl = P.precs[-1], R.precs[-1]
    gate((pl.dense_matrix is None) == (rl.dense_matrix is None), "tail")
    if rl.dense_matrix is not None:
        close(pl.dense_matrix, rl.dense_matrix, "dense tail")
        pd, rd = pl.dense_solver, rl.dense_solver
        gate((pd.kind, pd.rank) == (rd.kind, rd.rank), "tail kind or rank")
    return worst


def pack_bytes(torch, dp) -> dict:
    """Device bytes of a pack by operand: level-scan schedules, sliced ELL
    (E, F and the blocked inverses' Off_b), blocked inverses, dense
    inverses, the tail and the per-level vectors; the adjoint operands
    (``pack_transpose``) apart.  A storage shared by two tensors counts
    once."""
    import dataclasses

    from hifir_tpu_torch.ops.trsv import TrsvBlockDense, TrsvSchedule

    seen = set()

    def nbytes(o) -> int:
        if torch.is_tensor(o):
            st = o.untyped_storage()
            if st.data_ptr() in seen:
                return 0
            seen.add(st.data_ptr())
            return st.nbytes()
        if dataclasses.is_dataclass(o):
            return sum(nbytes(getattr(o, f.name))
                       for f in dataclasses.fields(o))
        if isinstance(o, (tuple, list)):
            return sum(nbytes(x) for x in o)
        return 0

    def forms(out, tri, ell):
        for f in tri:
            if isinstance(f, TrsvSchedule):
                out["schedules"] += nbytes(f)
            elif isinstance(f, TrsvBlockDense):
                out["blocked_inverses"] += nbytes(f.invs)
                out["ell"] += nbytes(f.offs)
            else:
                out["dense_inverses"] += nbytes(f)
        out["ell"] += nbytes(ell)

    keys = ("schedules", "ell", "blocked_inverses", "dense_inverses")
    fwd = dict.fromkeys(keys, 0)
    for lv in dp.levels:
        forms(fwd, (lv.L, lv.U), (lv.E, lv.F))
    fwd["vectors"] = sum(nbytes([lv.p, lv.q_inv, lv.s_p, lv.t, lv.d, lv.q,
                                 lv.p_inv, lv.s, lv.t_q])
                         for lv in dp.levels)
    fwd["tail"] = nbytes(dp.tail)
    out = {"forward": fwd}
    if dp.tran is not None:
        adj = dict.fromkeys(keys, 0)
        for t in dp.tran:
            forms(adj, (t.LT, t.UT), (t.ET, t.FT))
        out["adjoint"] = adj
    return out


@contextlib.contextmanager
def anchors():
    """The port's factorize on its numpy anchors (RCM, the numpy MC64, the
    Crout anchors), its native host library switched off: how the JAX
    package wrote the checked-in fixtures, without its library."""
    from hifir_tpu_torch.pre import _native

    load = _native._load
    _native._load = lambda: None
    try:
        yield
    finally:
        _native._load = load


def count_launches(torch, launches, what, fn):
    """``fn()`` with the launch counts set to 0 just before it and read into
    ``launches[what]`` just after."""
    torch.cuda.synchronize()
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launches[what] = read_counts()
    return out


def factorize_phase(torch, rng):
    """The port's own factorize, from a matrix A to the M-solve on the card
    with no file that the JAX package wrote: the convdiff2d(128) factorize
    on the numpy anchors held equal to the checked-in fixture, then
    poisson2d(256) (bench.py's options) factorized on the anchors (its
    native factorize timed beside it), packed ``auto`` f32 and f64 and
    ``dense_inv=0`` f32, solved forward and adjoint at 128 RHS against the
    port's plain f64 CPU solve, and refined by HIFIR with A = BSR(bs=128).
    Each part runs with the launch counts set to 0 just before it and read
    just after; returns the report, the launches of each part with what
    each must be, the packs and the right-hand sides."""
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.models.problems import convdiff2d, poisson2d
    from hifir_tpu_torch.ops.bsr_spmv import bsr_from_csr
    from hifir_tpu_torch.ops.spmv import ell_matvec_mrhs
    from hifir_tpu_torch.ops.trsv import TrsvSchedule

    launches, want, report = {}, {}, {}
    cpu = cpu_model()

    # 1. convdiff2d(128) with the fixture's options: the fixture itself
    t0 = time.perf_counter()
    with anchors():
        Pc = ht.HIF().factorize(convdiff2d(128), ht.Options(**FIXTURE_OPTS))
    secs = time.perf_counter() - t0
    worst = levels_equal(Pc, ht.load_prec(CONVDIFF))
    report["convdiff_factorize"] = dict(seconds=secs, cpu=cpu,
                                        max_rel_diff=worst)
    log(f"  factorize convdiff2d(128): {secs:.2f} s on the host ({cpu}); "
        f"levels {[(p.m, p.n) for p in Pc.precs]}, equal to the fixture "
        f"(largest value difference {worst:.1e}, tol 1e-12)")

    # 2. poisson2d(256) with bench.py's options, on the anchors (its rows
    # stay comparable with the earlier runs'); its native factorize timed
    A = poisson2d(256)
    n = A.nrows
    t0 = time.perf_counter()
    with anchors():
        P = ht.HIF().factorize(A, ht.Options(**BENCH_OPTS))
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    Pn = ht.HIF().factorize(A, ht.Options(**BENCH_OPTS))
    nsecs = time.perf_counter() - t0
    lv = [(p.m, p.n) for p in P.precs]
    tail = P.precs[-1].dense_matrix
    report["poisson256_factorize"] = dict(
        seconds=secs, cpu=cpu, levels=lv, nnz_M=P.nnz(), nnz_A=A.nnz,
        fill=P.nnz() / A.nnz,
        tail=None if tail is None else tail.shape[0],
        native_seconds=nsecs, native_levels=[(p.m, p.n) for p in Pn.precs],
        native_nnz_M=Pn.nnz())
    log(f"  factorize poisson2d(256): {secs:.2f} s on the anchors, "
        f"{nsecs:.2f} s native, on the host ({cpu}); anchors' levels {lv}, "
        f"tail {None if tail is None else tail.shape}, nnz(M)={P.nnz()}, "
        f"fill {P.nnz() / A.nnz:.4f}; native levels "
        f"{[(p.m, p.n) for p in Pn.precs]}, fill {Pn.nnz() / A.nnz:.4f}")
    gate(P.precs[0].m > 8 * 2048, "poisson2d(256): level 0 is not above "
         "the blocked-inverse range, so K2 would not carry the auto solve")

    B = rng.standard_normal((n, NRHS))
    ref_pack = P.to_device(dtype=np.float64, device="cpu", dense_inv=0)
    ref_pack.pack_transpose(P.precs)
    ref = {t: ref_pack.solve_mrhs(B, trans=t).numpy() for t in (False, True)}
    packs = {}
    for di, npdt in (("auto", np.float32), ("auto", np.float64),
                     (0, np.float32)):
        t0 = time.perf_counter()
        dp = P.to_device(dtype=npdt, dense_inv=di)
        dp.pack_transpose(P.precs)
        dt = np.dtype(npdt).name
        packs[(di, dt)] = dp
        nb = pack_bytes(torch, dp)
        report[f"bytes dense_inv={di} {dt}"] = nb
        log(f"  pack + pack_transpose dense_inv={di!s:4s} {dt}: "
            f"{time.perf_counter() - t0:.2f} s (host); bytes forward "
            f"{nb['forward']}, adjoint {nb['adjoint']}")
    Bd = {dt: torch.as_tensor(B, dtype=getattr(torch, dt), device="cuda")
          for dt in ("float32", "float64")}
    for (di, dt), dp in packs.items():
        for trans in (False, True):
            key = (f"poisson256 {'adjoint' if trans else 'forward'} "
                   f"dense_inv={di} {dt}")
            X = count_launches(torch, launches, key,
                               lambda: dp.solve_mrhs(Bd[dt], trans=trans))
            gate(bool(torch.isfinite(X).all()), f"{key}: non-finite")
            gate(tuple(X.shape) == (n, NRHS), f"{key}: shape")
            d = float(np.abs(X.double().cpu().numpy() - ref[trans]).max()
                      / np.abs(ref[trans]).max())
            tol = 1e-4 if dt == "float32" else 1e-10
            forms = ([(t.LT, t.UT, t.FT, t.ET) for t in dp.tran] if trans
                     else [(v.L, v.U, v.E, v.F) for v in dp.levels])
            want[key] = want_launches(forms)
            report[key] = dict(rel_diff=d, tol=tol)
            log(f"  M-solve {key:42s}: rel diff vs CPU f64 {d:.3e} (tol "
                f"{tol:.0e}); launches {launches[key]}, by the pack's forms "
                f"{want[key]}")
            gate(d <= tol, f"{key}: {d:.3e} > {tol}")
    for dt in ("float32", "float64"):
        lv0 = packs[("auto", dt)].levels[0]
        gate(isinstance(lv0.L, TrsvSchedule) and lv0.L.nchunks > 0
             and launches[f"poisson256 forward dense_inv=auto {dt}"]["K2"]
             >= 2, f"the auto {dt} pack did not launch K2 on level 0")

    # 3. HIFIR, f64, A = BSR(poisson2d(256), bs=128): the residual falls
    # every step for every column; K7 3 times and K1 4 solves' worth
    dp = packs[("auto", "float64")]
    Ab = bsr_from_csr(A, bs=128, dtype=np.float64)
    Bt = Bd["float64"]
    Xs = [ht.ir_apply(Ab, dp, Bt, k) for k in range(1, 4)]
    Xs.append(count_launches(torch, launches,
                             "poisson256 hifir nirs=4 float64",
                             lambda: ht.ir_apply(Ab, dp, Bt, 4)))
    per = want_launches([(v.L, v.U, v.E, v.F) for v in dp.levels])
    want["poisson256 hifir nirs=4 float64"] = dict(
        K7=3, K1=4 * per["K1"], K2=4 * per["K2"])
    res = np.array([torch.linalg.vector_norm(
        Bt - ell_matvec_mrhs(Ab, Xk), dim=0).cpu().numpy() for Xk in Xs])
    rel_res = res / np.linalg.norm(B, axis=0)
    report["poisson256 hifir rel residual"] = list(
        map(float, rel_res.max(axis=1)))
    log("  HIFIR poisson2d(256) (BSR A, f64) max relative residual per "
        "step: " + ", ".join(f"{v:.3e}" for v in rel_res.max(axis=1))
        + f"; launches {launches['poisson256 hifir nirs=4 float64']}")
    gate(bool(np.all(res[1:] < res[:-1])), "poisson2d(256) HIFIR residual "
         "did not fall at every step for every column")
    for key, w in want.items():
        for k, v in w.items():
            got = launches[key][k]
            gate(got == v, f"{key}: {got} {k} launches, expected {v}")
    return report, launches, want, packs, Bd, Ab


def time_factorize(torch, packs, Bd, Ab, reps=CHAIN):
    """``reps`` back-to-back M-solves per poisson-256 pack, forward and
    adjoint, and the nirs=4 HIFIR apply (CUDA events), each with a
    torch.profiler breakdown."""
    import hifir_tpu_torch as ht

    out, profiles = {}, {}
    runs = {}
    for (di, dt), dp in packs.items():
        for trans in (False, True):
            key = (f"poisson256 {'adjoint' if trans else 'forward'} "
                   f"dense_inv={di} {dt}")
            runs[key] = (lambda dp=dp, dt=dt, trans=trans:
                         dp.solve_mrhs(Bd[dt], trans=trans))
    runs["poisson256 hifir nirs=4 float64"] = lambda: ht.ir_apply(
        Ab, packs[("auto", "float64")], Bd["float64"], 4)
    for key, run in runs.items():
        ms = timed(torch, run, 5 if "hifir" in key else reps)
        out[key] = dict(ms=ms, us_per_rhs=ms * 1e3 / NRHS)
        log(f"  {key:44s}: {ms:.4f} ms, {ms * 1e3 / NRHS:.4f} us/RHS")
    log("  where the time goes (torch.profiler):")
    for key, run in runs.items():
        profiles[key] = device_profile(torch, run, 3 if "hifir" in key
                                       else 5)
        log_profile(key, profiles[key], out[key]["ms"])
    return out, profiles


# K8's seeded Gaussian matrices, beside the fixtures' tails and the tie set
K8_RANDOM = (1, 2, 33, 736, 2000)
# from this n on, the plain route on the card (~45 launches a column step)
# runs once, for the comparison, and that run is its time
K8_PLAIN_ONCE = 736
K8_TOL = {"float64": 1e-12, "float32": 1e-5}
# the factorization's own gates: |QR - AP| / |A| and |Q^T Q - I|
K8_RESIDUAL = {"float64": 1e-13, "float32": 1e-4}
K8_SOURCE = ("hifir_tpu_torch/csrc/kernels.cu", "qrcp_kernel",
             "hifir_tpu/small_scale/qrcp_device.py:27")
# the matrices that also run in the "global_x" layout, forced
K8_FORCED = ("random33", "random736")
# the first f64 n whose x, map and inverse leave shared memory on 132 SMs
# ("global_x"), run once; its gates (n eps ~ 1.6e-12 with margin: the
# backward error of Householder QR grows with n)
K8_LARGE = 14465
K8_LARGE_TOL = 1e-11


def k8_matrices(rng) -> list:
    """K8's matrices as float64 arrays: (name, A, pivot positions compared,
    rank).  The two fixtures' tails, the 40x40 rank-25 matrix (its 25
    leading positions: past the rank the choice falls among rounding
    noise), seeded Gaussian n = 1, 2, 33, 736 and 2000, and the tie set of
    8x8 matrices whose pivots the position rule decides: the identity and a
    permutation (every norm ties at every step), two equal columns, a zero
    column and the zero matrix (every position compared: past the rank the
    norms are exact zeros or one column is left).  Q and R are compared on
    the rank's columns and rows: past it the reflector's sign follows the
    sign of rounding noise."""
    import hifir_tpu_torch as ht

    mats = [(name, ht.load_prec(path).precs[-1].dense_matrix, None, None)
            for name, path in (("frozen", FIXTURE), ("convdiff", CONVDIFF))]
    mats.append(("rank25", deficient_tail("qrcp").precs[-1].dense_matrix,
                 25, 25))
    mats += [(f"random{n}", rng.standard_normal((n, n)), None, None)
             for n in K8_RANDOM]
    B = rng.standard_normal((8, 8))
    eq, zc = B.copy(), B.copy()
    eq[:, 5] = eq[:, 2]
    zc[:, 3] = 0.0
    mats += [("identity8", np.eye(8), None, None),
             ("permutation8", np.eye(8)[rng.permutation(8)], None, None),
             ("equal_columns8", eq, None, 7), ("zero_column8", zc, None, 7),
             ("zero8", np.zeros((8, 8)), None, 0)]
    return [(name, A, A.shape[0] if lead is None else lead,
             A.shape[0] if rank is None else rank)
            for name, A, lead, rank in mats]


def qr_dist(torch, F, Fref, m: int):
    """Q[:, :m] and R[:m] of factorization F = (Q, R, piv) against Fref's,
    each reflector's sign taken from R's diagonal (a zero counts as +) and
    R's rows put back in the original column order (R P^T = Q^T A, so rows
    below m compare whatever the later pivots): Q's largest difference and
    R's, each relative to Fref's largest entry, and the largest absolute
    difference of the two."""
    if m == 0:
        return 0.0, 0.0, 0.0

    def normal(Q, R, piv):
        s = torch.where(R.diagonal()[:m] < 0, -1.0, 1.0).double()
        Ro = torch.empty((m, R.shape[1]), dtype=torch.float64,
                         device=R.device)
        Ro[:, piv] = R[:m].double() * s[:, None]
        return Q[:, :m].double() * s, Ro

    (q, r), (qr, rr) = normal(*F), normal(*Fref)
    dq, dr = float((q - qr).abs().max()), float((r - rr).abs().max())
    return (dq / max(float(Fref[0].abs().max()), 1e-300),
            dr / max(float(Fref[1].abs().max()), 1e-300), max(dq, dr))


def first_diff(a, b, m: int) -> int:
    """The first position below m where pivot vectors a and b differ (m if
    none)."""
    d = np.flatnonzero(a[:m] != b[:m])
    return int(d[0]) if d.size else m


def near_tie(torch, A64, prefix, a: int, b: int, dtype: str):
    """Whether columns a and b were a tie at ``dtype``'s precision after the
    pivots ``prefix``: their residual norms^2 once A[:, prefix] is
    projected out, computed in f64 on the card, differ by more than 1e-12
    (no exact tie, which the position rule decides) and less than
    delta = n eps(dtype) n / (n - s) (the downdated norms' drift after s
    steps, relative to the trailing norms), and both lie within delta of
    the largest.  Returns (verdict, relative gap, delta)."""
    n, s = A64.shape[0], len(prefix)
    delta = n * float(np.finfo(dtype).eps) * n / (n - s)
    rest = np.setdiff1d(np.arange(n), prefix)
    Ar = A64[:, torch.as_tensor(rest, device=A64.device)]
    if s:
        Qs = torch.linalg.qr(A64[:, torch.as_tensor(prefix,
                                                    device=A64.device)])[0]
        Ar = Ar - Qs @ (Qs.T @ Ar)
    r2 = (Ar * Ar).sum(0)
    top = float(r2.max())
    ra = float(r2[int(np.flatnonzero(rest == a)[0])])
    rb = float(r2[int(np.flatnonzero(rest == b)[0])])
    gap = abs(ra - rb) / max(ra, rb, 1e-300)
    ok = (1e-12 < gap < delta and ra >= (1 - delta) * top
          and rb >= (1 - delta) * top)
    return ok, gap, delta


def k8_check(torch, name, D, lead, rank, dt, plain64, layout=None):
    """One K8 factorization of D in dtype ``dt`` on the card against the
    plain version's (see :func:`k8_phase`), in ``layout`` (default: the
    plan's); ``plain64`` holds the plain f64 factors by name (filled in the
    f64 pass at the plan's layout, read in the f32 one).  Returns the
    record and the card's A."""
    import scipy.linalg as sla

    import hifir_tpu_torch as ht
    from hifir_tpu_torch.small_scale.qrcp_device import (
        qrcp_device, qrcp_device_cuda, qrcp_device_plain, qrcp_plan,
        qrcp_rank)

    dname = str(dt).removeprefix("torch.")
    n = D.shape[0]
    Ad = torch.as_tensor(D, dtype=dt, device="cuda")
    plan = qrcp_plan(n, dt, layout=layout)
    torch.cuda.synchronize()
    k0, p0 = qrcp_device_cuda.launches, qrcp_device_plain.calls
    torch.cuda.set_sync_debug_mode("error")
    try:
        F = (qrcp_device(Ad) if layout is None
             else qrcp_device_cuda(Ad, layout=layout))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    gate(qrcp_device_cuda.launches == k0 + 1
         and qrcp_device_plain.calls == p0,
         f"K8 {name} {dname}: not one kernel launch")
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    Fp = qrcp_device_plain(Ad)
    e.record()
    torch.cuda.synchronize()
    if dt == torch.float64 and layout is None:
        plain64[name] = Fp
    Q, R, piv = F
    pk, pp = piv.cpu().numpy(), Fp[2].cpu().numpy()
    s1 = first_diff(pk, pp, lead)
    m, tie = min(s1, rank), None
    if s1 < lead:
        ok, gap, delta = (near_tie(torch, torch.as_tensor(D, device="cuda"),
                                   pk[:s1], int(pk[s1]), int(pp[s1]), dname)
                          if dt == torch.float32 else (False, None, None))
        tie = dict(position=s1, kernel=int(pk[s1]), plain=int(pp[s1]),
                   gap=gap, delta=delta, ok=ok)
        log(f"  K8 {name} {dname}: pivots differ at {s1} ({pk[s1]} / "
            f"{pp[s1]}); f64 residual gap {gap} (delta {delta}): "
            f"{'a tie' if ok else 'no tie'}")
        gate(ok, f"K8 {name} {dname}: pivot {s1} differs from the plain "
             "version's")
    tol = K8_TOL[dname]
    dq, dr, dabs = qr_dist(torch, F, Fp, m)
    acc = None
    if dt == torch.float32 and max(dq, dr) > tol:
        # beyond 1e-5 (the Gaussian matrices' n kappa eps): the kernel's
        # and the plain version's f32 factors against the plain f64 ones,
        # where all three pivot orders agree
        F64 = plain64[name]
        p64 = F64[2].cpu().numpy()
        mm = min(m, first_diff(pp, p64, lead), first_diff(pk, p64, lead))
        k64 = max(qr_dist(torch, F, F64, mm)[:2])
        p32 = max(qr_dist(torch, Fp, F64, mm)[:2])
        acc = dict(compared=mm, kernel_vs_f64=k64, plain_vs_f64=p32,
                   tol=max(tol, 2 * p32))
        log(f"  K8 {name} {dname}: Q {dq:.2e}, R {dr:.2e} from the plain "
            f"version; against the plain f64 factors on {mm} positions: "
            f"kernel {k64:.2e}, plain {p32:.2e} (tol max(1e-5, twice the "
            f"plain's) {acc['tol']:.2e})")
        gate(k64 <= acc["tol"], f"K8 {name} {dname}: {k64:.2e} from the "
             f"f64 factors, the plain version {p32:.2e}")
    A64 = Ad.double()
    res = float((Q.double() @ R.double() - A64[:, piv]).abs().max()
                / max(float(A64.abs().max()), 1e-300))
    orth = float((Q.double().T @ Q.double() - torch.eye(
        n, dtype=torch.float64, device="cuda")).abs().max())
    rtol = K8_RESIDUAL[dname]
    rec = dict(name=name, dtype=dname, n=n, lead=lead, rank=rank,
               compared=m, pivot_tie=tie, q_rel=dq, r_rel=dr,
               max_abs_err=dabs, tol=tol, accuracy=acc, residual=res,
               orthogonality=orth, layout=plan["layout"], grid=plan["grid"],
               forced=layout is not None,
               cols=plan["cols"], plain_once_ms=s.elapsed_time(e))
    log(f"  K8 {name:14s} {dname} n={n:4d} ({plan['layout']}, "
        f"{plan['grid']} CTAs of {plan['cols']}): pivots equal on {s1} of "
        f"{lead}; Q and R on {m}: {dq:.2e}, {dr:.2e} (tol {tol:.1e}); "
        f"|QR - AP| {res:.2e}, |Q^T Q - I| {orth:.2e} (tol {rtol:.0e})")
    gate((dq <= tol and dr <= tol) or acc is not None, f"K8 {name} {dname}:"
         f" Q {dq:.2e} or R {dr:.2e} above {tol:.1e}")
    gate(res <= rtol and orth <= rtol, f"K8 {name} {dname}: residual "
         f"{res:.2e} or orthogonality {orth:.2e} above {rtol:.0e}")
    if name in ("frozen", "convdiff") and dt == torch.float64:
        host = ht.load_prec(FIXTURE if name == "frozen"
                            else CONVDIFF).precs[-1].dense_solver
        _, _, lpiv = sla.qr(D, pivoting=True, mode="economic")
        qrank = qrcp_rank(R)
        same = bool(np.array_equal(pk, lpiv))
        rec.update(qrcp_rank=qrank, pivots_equal_geqp3=same)
        log(f"  K8 {name} f64: pivots equal to geqp3's {same}, rank {qrank} "
            f"(host {host.rank})")
        gate(same, f"K8 {name}: pivots differ from geqp3's")
        gate(qrank == host.rank, f"K8 {name}: rank {qrank} != {host.rank}")
    return rec, Ad


def k8_profile(torch, As, dname):
    """One profiler window over K8 on every matrix of ``As``: it must hold
    one qrcp_kernel a factorization and nothing else.  Returns the copies
    seen (0)."""
    from torch.autograd import DeviceType

    from hifir_tpu_torch.small_scale.qrcp_device import qrcp_device

    run_all = lambda: [qrcp_device(a) for a in As]
    for take in range(1, PROFILE_TAKES + 1):
        prof, offset = profiled(torch, run_all)
        names = [ev.name for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA
                 and not ev.name.startswith("ProfilerStep")]
        kernels = [x for x in names if not x.startswith(("Memcpy",
                                                          "Memset"))]
        copies = len(names) - len(kernels)
        lost = len(kernels) < len(As)
        PROFILE_WINDOWS.append(dict(offset_ms=offset, take=take, lost=lost))
        if not lost:
            break
    log(f"  K8 {dname}: {len(kernels)} device kernels, {copies} copies for "
        f"{len(As)} factorizations in the profiler (clock offset {offset} "
        "ms)")
    gate(len(kernels) == len(As) and copies == 0
         and all("qrcp_kernel" in x for x in kernels),
         f"K8 {dname}: the profiler holds {len(kernels)} kernels and "
         f"{copies} copies for {len(As)} factorizations")
    return copies


def k8_row(torch, T, name, D, Ad, rec, copies, smi):
    """K8's row at one matrix: the kernel, the plain route on the card
    (from K8_PLAIN_ONCE on, its one comparison run), torch.geqrf on the
    card (CUDA events) and the host geqp3 (host clock), beside the bound."""
    import scipy.linalg as sla

    from hifir_tpu_torch.small_scale.qrcp_device import (qrcp_device,
                                                         qrcp_device_plain)

    n, dname = D.shape[0], rec["dtype"]
    ms = T.ms(lambda: qrcp_device(Ad), iters=10)
    plain_ms = (rec["plain_once_ms"] if n >= K8_PLAIN_ONCE else
                timed(torch, lambda: qrcp_device_plain(Ad), 2))
    geqrf_ms = T.ms(lambda: torch.geqrf(Ad), iters=10)
    host_ms = []
    for _ in range(1 if n >= K8_PLAIN_ONCE else 5):
        t0 = time.perf_counter()
        sla.qr(D.astype(dname), pivoting=True, mode="economic",
               check_finite=False)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    # A read once, Q and R written once, piv; (8/3) n^3 FLOP
    bms, by = bound(3 * n * n * Ad.element_size() + 8 * n, 8 / 3 * n ** 3,
                    dname)
    row = dict(name=f"K8_qrcp_{name}", route="cuda", source=K8_SOURCE[0],
               symbol=K8_SOURCE[1], replaces=K8_SOURCE[2], dtype=dname,
               shape=f"{n}x{n} {dname}", layout=rec["layout"],
               grid=rec["grid"], cols=rec["cols"],
               launches_per_factorization=1, copies=copies,
               max_abs_err=rec["max_abs_err"], ms=ms,
               us_per_step=ms * 1e3 / n, plain_ms=plain_ms,
               plain_route="the eager loop on the card",
               geqp3_ms=statistics.median(host_ms), geqrf_ms=geqrf_ms,
               library_ms=None,
               library_note="no PyTorch call pivots; torch.geqrf "
               "(geqrf_ms) is the unpivoted QR of the same A",
               bound_ms=bms, bound_by=by)
    log(f"  K8 {name} {dname} {n}x{n}: {ms:.4f} ms ({row['us_per_step']:.2f}"
        f" us a column step, {rec['layout']} layout), plain on the card "
        f"{plain_ms:.2f} ms, host geqp3 {row['geqp3_ms']:.3f} ms, "
        f"torch.geqrf {geqrf_ms:.4f} ms (unpivoted), bound {bms:.4f} ms "
        f"({by}) [{smi}]")
    return row


def k8_path(torch, rng, smi, report):
    """The K8 path, its launches counted from 0: the auto f64 M-solve of a
    tail_on_device pack against the host-tail pack on each fixture (1e-10;
    both packs timed) and HIF.factorize(convdiff2d(128))
    with device_tail=1 against 0 (host seconds, rank, M-solve 1e-8).
    Returns the path's launches."""
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.models.problems import convdiff2d
    from hifir_tpu_torch.small_scale.dense import DeviceQRCP
    from hifir_tpu_torch.small_scale.qrcp_device import (qrcp_device,
                                                         qrcp_device_cuda)

    def pack(M, tail_on_device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dp = M.to_device(dtype=np.float64, tail_on_device=tail_on_device)
        torch.cuda.synchronize()
        return dp, (time.perf_counter() - t0) * 1e3

    torch.cuda.synchronize()
    qrcp_device_cuda.launches = 0
    for name, path in (("frozen", FIXTURE), ("convdiff", CONVDIFF)):
        M = ht.load_prec(path)
        B = torch.as_tensor(rng.standard_normal((M.precs[0].n, NRHS)),
                            device="cuda")
        calls = qrcp_device.calls
        dpd, ms_d = pack(M, True)
        gate(qrcp_device.calls == calls + 1, "tail_on_device did not run K8")
        dph, ms_h = pack(M, False)
        d = rel_diff(dpd.solve_mrhs(B), dph.solve_mrhs(B))
        log(f"  tail_on_device auto f64 M-solve on {name}: rel diff vs the "
            f"host-tail pack {d:.3e} (tol 1e-10); to_device(float64) "
            f"{ms_d:.2f} ms with the tail on the card, {ms_h:.2f} ms with "
            f"the host's (host clock) [{smi}]")
        gate(d <= 1e-10, f"tail_on_device {name}: {d:.3e} > 1e-10")
        report[f"tail_on_device {name}"] = dict(
            rel_diff=d, to_device_ms=ms_d, host_tail_to_device_ms=ms_h)
    Ac = convdiff2d(128)
    fact, secs = {}, {}
    for dtail in (1, 0, 1, 0):
        t0 = time.perf_counter()
        fact[dtail] = ht.HIF().factorize(Ac, ht.Options(
            **dict(FIXTURE_OPTS, device_tail=dtail)))
        torch.cuda.synchronize()
        secs.setdefault(dtail, []).append(time.perf_counter() - t0)
    dd, dh = (fact[k].precs[-1].dense_solver for k in (1, 0))
    B = torch.as_tensor(rng.standard_normal((Ac.nrows, NRHS)), device="cuda")
    d = rel_diff(fact[1].to_device(dtype=np.float64).solve_mrhs(B),
                 fact[0].to_device(dtype=np.float64).solve_mrhs(B))
    same = bool(np.array_equal(dd.jpvt, dh.jpvt))
    report["device_tail_factorize"] = dict(
        seconds_device_tail=min(secs[1]), seconds_host_tail=min(secs[0]),
        cpu=cpu_model(), tail=dd.n, rank=dd.rank, host_rank=dh.rank,
        pivots_equal_geqp3=same, solve_rel_diff=d)
    log(f"  HIF.factorize(convdiff2d(128)): device_tail=1 {min(secs[1]):.3f}"
        f" s, device_tail=0 {min(secs[0]):.3f} s (host clock, best of 2, "
        f"{cpu_model()}); tail {dd.n}, rank {dd.rank} (host {dh.rank}), "
        f"pivots equal to geqp3's {same}, M-solve rel diff {d:.3e} (tol "
        "1e-8)")
    gate(isinstance(dd, DeviceQRCP) and dd.rank == dh.rank and d <= 1e-8,
         "device_tail=1: the tail's rank or the M-solve differs")
    torch.cuda.synchronize()
    launches = qrcp_device_cuda.launches
    log(f"  K8 launches on the K8 path: {launches}")
    gate(launches > 0, "K8 was not launched on its path")
    return launches


def k8_phase(torch, T, rng, smi):
    """K8, the device QRCP, one cooperative launch of qrcp_kernel, against
    its plain version (the eager loop) on the card, in f64 and f32, on
    :func:`k8_matrices` (:func:`k8_check`): the kernel's call under
    torch.cuda.set_sync_debug_mode("error") (a host sync inside fails the
    run), exactly one launch and no plain call by the counters; pivots
    equal to the plain version's on the compared positions (f64: in full;
    f32: up to a first difference only where :func:`near_tie` certifies a
    tie at f32 precision, the comparison of Q and R stopping there), Q and
    R within 1e-12 (f64) of the plain version's (:func:`qr_dist`), or in
    f32 within 1e-5 or, where they are not (the Gaussian matrices' n kappa
    eps), no farther from the plain f64 factors than twice the plain
    version's f32 ones; |QR - AP| and |Q^T Q - I| within 1e-13 (f64) /
    1e-4 (f32); on the fixtures in f64, pivots equal to scipy's geqp3 and
    the rank to the host's.  A profiler window a dtype holds one
    qrcp_kernel a factorization and nothing else (:func:`k8_profile`).
    Rows at the fixtures' tails and the largest Gaussian matrix
    (:func:`k8_row`); the layouts (shared at the tails, global at 2000); a
    grid that cannot be co-resident refused; the "global_x" layout forced
    on K8_FORCED; the K8 path (:func:`k8_path`); the complex tail's host
    fallback; the rank rule (:func:`rank_rule_phase`); n = K8_LARGE once
    (:func:`k8_large`).  Returns the rows, the report and the K8 path's
    launches."""
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.small_scale.dense import DeviceQRCP
    from hifir_tpu_torch.small_scale.qrcp_device import (qrcp_device,
                                                         qrcp_device_cuda)

    mats = k8_matrices(rng)
    big = f"random{max(K8_RANDOM)}"
    rows, report, plain64 = [], {"matrices": []}, {}
    for dt in (torch.float64, torch.float32):
        recs, outs = {}, {}
        for name, D, lead, rank in mats:
            recs[name], outs[name] = k8_check(torch, name, D, lead, rank, dt,
                                              plain64)
        report["matrices"] += recs.values()
        copies = k8_profile(torch, list(outs.values()),
                            str(dt).removeprefix("torch."))
        rows += [k8_row(torch, T, name, D, outs[name], recs[name], copies,
                        smi)
                 for name, D, _, _ in mats
                 if name in ("frozen", "convdiff", big)]

    lay = {r["name"]: r["layout"] for r in report["matrices"]
           if r["dtype"] == "float64"}
    gate(lay["frozen"] == "shared" and lay[big] == "global",
         f"K8 layouts {lay}")
    # a grid that cannot be co-resident is an error, never a smaller grid
    try:
        qrcp_device_cuda(outs[big], cols_per_cta=1)
        refused = None
    except RuntimeError as err:
        refused = str(err)
    log(f"  K8 at one column a CTA on {big}: refused ({refused})")
    gate(refused is not None, f"K8: a grid of a CTA a column on {big} was "
         "launched")
    report["refused"] = refused

    # the "global_x" layout forced at small n, against the plain route
    report["forced_global_x"] = [
        k8_check(torch, name, D, lead, rank, dt, plain64,
                 layout="global_x")[0]
        for dt in (torch.float64, torch.float32)
        for name, D, lead, rank in mats if name in K8_FORCED]

    launches = k8_path(torch, rng, smi, report)
    report.update(rank_rule_phase(torch, rng))
    rows.append(k8_large(torch, rng, smi, report))
    # the complex fixture's 25x25 tail takes the host QRCP
    Dz = ht.load_prec(CONVDIFF_C).precs[-1].dense_matrix
    calls = qrcp_device.calls
    dz = DeviceQRCP("cuda")
    dz.factorize(Dz)
    gate(qrcp_device.calls == calls and dz.rank == Dz.shape[0],
         "the complex tail did not take the host QRCP")
    log(f"  complex {Dz.shape[0]}x{Dz.shape[0]} tail: host QRCP fallback, "
        f"rank {dz.rank}")
    return rows, report, launches


def k8_large(torch, rng, smi, report) -> dict:
    """K8 once at n = K8_LARGE in f64 on a seeded Gaussian A made on the
    card, in the "global_x" layout the plan picks there: one launch and no
    host sync; |A[:, piv] - Q R| / |A| and |Q^T Q - I| within K8_LARGE_TOL
    (torch.matmul, TF32 off); piv a permutation whose first entry is A's
    column of largest norm.  The plain route (~3 ms a column step) is not
    run.  Returns K8's row at this n."""
    from hifir_tpu_torch.small_scale.qrcp_device import (qrcp_device,
                                                         qrcp_device_cuda,
                                                         qrcp_device_plain,
                                                         qrcp_plan)

    n = K8_LARGE
    plan = qrcp_plan(n, torch.float64)
    gate(plan["layout"] == "global_x", f"K8 n = {n}: layout {plan}")
    g = torch.Generator(device="cuda")
    g.manual_seed(int(rng.integers(2**62)))
    A = torch.randn((n, n), generator=g, dtype=torch.float64, device="cuda")
    torch.cuda.synchronize()
    k0, p0 = qrcp_device_cuda.launches, qrcp_device_plain.calls
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        s.record()
        Q, R, piv = qrcp_device(A)
        e.record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ms = s.elapsed_time(e)
    gate(qrcp_device_cuda.launches == k0 + 1
         and qrcp_device_plain.calls == p0, f"K8 n = {n}: not one launch")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = float((A[:, piv] - Q @ R).abs().max() / A.abs().max())
        Q = Q.T @ Q
        Q.diagonal().sub_(1.0)
        orth = float(Q.abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    p = piv.cpu().numpy()
    perm = bool(np.array_equal(np.sort(p), np.arange(n)))
    first = int(torch.argmax((A * A).sum(0)))
    del A, Q, R
    torch.cuda.empty_cache()
    # A read once, Q and R written once, piv; (8/3) n^3 FLOP
    bms, by = bound(3 * n * n * 8 + 8 * n, 8 / 3 * n ** 3, "float64")
    row = dict(name=f"K8_qrcp_random{n}", route="cuda", source=K8_SOURCE[0],
               symbol=K8_SOURCE[1], replaces=K8_SOURCE[2], dtype="float64",
               shape=f"{n}x{n} float64", layout=plan["layout"],
               grid=plan["grid"], cols=plan["cols"],
               launches_per_factorization=1, max_abs_err=res, residual=res,
               orthogonality=orth, ms=ms, us_per_step=ms * 1e3 / n,
               plain_ms=None, plain_route="not run at this n (~3 ms a "
               "column step, about a minute)", library_ms=None,
               library_note="no PyTorch call pivots", bound_ms=bms,
               bound_by=by)
    report["large"] = row
    log(f"  K8 n={n} f64 ({plan['layout']}, {plan['grid']} CTAs of "
        f"{plan['cols']}): {ms:.1f} ms ({row['us_per_step']:.1f} us a "
        f"column step); |QR - AP| / |A| {res:.2e}, |Q^T Q - I| {orth:.2e} "
        f"(tol {K8_LARGE_TOL:.0e}); piv a permutation {perm}, piv[0] {p[0]}"
        f" (largest column norm {first}); bound {bms:.1f} ms ({by}) [{smi}]")
    gate(res <= K8_LARGE_TOL and orth <= K8_LARGE_TOL,
         f"K8 n = {n}: residual {res:.2e} or orthogonality {orth:.2e}")
    gate(perm and p[0] == first, f"K8 n = {n}: piv is not a permutation "
         f"led by the column of largest norm ({p[0]} / {first})")
    return row


def deficient_tail(kind: str, n: int = 40, rank: int = 25, seed: int = 0):
    """A one-level preconditioner that is all dense tail (m = 0): an n x n
    matrix of rank ``rank`` (``tests/test_device.py``'s 40x40 rank-25 one
    for QRCP, a symmetric one of that rank for SYEIG)."""
    import hifir_tpu_torch as ht

    rng = np.random.default_rng(seed)
    U = rng.standard_normal((n, rank))
    D = (U @ np.diag(rng.uniform(1.0, 2.0, rank)) @ U.T if kind == "syeig"
         else U @ rng.standard_normal((rank, n)))
    pay = {"nlevels": np.int64(1), "stats": np.zeros(1),
           "l0_mn": np.array([0, n]), "l0_dense": D,
           "l0_dense_kind": np.array(kind), "l0_d": np.empty(0),
           "l0_s": np.ones(n), "l0_t": np.ones(n)}
    for f, rows, cols in (("L_B", 0, 0), ("U_B", 0, 0), ("E", n, 0),
                          ("F", 0, n)):
        pay.update({f"l0_{f}_indptr": np.zeros(rows + 1, np.int64),
                    f"l0_{f}_indices": np.empty(0, np.int32),
                    f"l0_{f}_data": np.empty(0),
                    f"l0_{f}_shape": np.array([rows, cols])})
    for f in ("p", "p_inv", "q", "q_inv"):
        pay[f"l0_{f}"] = np.arange(n)
    return ht.HIF(ht.prec_from_arrays(pay))


def truncated_host_solve(ds, B, k: int) -> np.ndarray:
    """The dense tail's solve on the host keeping k columns (QRCP) or the
    k largest eigenvalues (SYEIG): what a rank rule that keeps k computes."""
    if ds.kind == "qrcp":
        X = np.zeros_like(B)
        X[ds.jpvt[:k]] = np.linalg.solve(ds.R[:k, :k], ds.Q[:, :k].T @ B)
        return X
    idx = np.argsort(-np.abs(ds.w))[:k]
    V = ds.V[:, idx]
    return V @ ((V.T @ B) / ds.w[idx][:, None])


def rank_rule_phase(torch, rng) -> dict:
    """The tail's rank rule on the card, on rank-deficient tails (40x40,
    rank 25, QRCP and SYEIG; r = rank + 1 < nm, where the rule that kept
    min(r, nm) columns differs): r = rank + 1 must give r = 0's solve
    (1e-12) and the host's truncated solve at the rank (1e-10), forward and
    adjoint, 128 RHS, f64.  Prints what keeping rank + 1 columns would
    give, so that the gate is seen to tell the two rules apart."""
    out = {}
    for kind in ("qrcp", "syeig"):
        H = deficient_tail(kind)
        ds = H.precs[-1].dense_solver
        dp = H.to_device(dtype=np.float64)
        dp.pack_transpose(H.precs)
        r, nm = dp.tail.rank, dp.tail.Q.shape[0]
        gate(r + 1 < nm, f"rank rule: the {kind} tail is not deficient "
             f"(rank {r} of {nm})")
        B = rng.standard_normal((nm, NRHS))
        Bd = torch.as_tensor(B, device="cuda")
        for trans in (False, True):
            X = dp.solve_mrhs(Bd, trans=trans, r=r + 1)
            d0 = rel_diff(X, dp.solve_mrhs(Bd, trans=trans, r=0))
            # the adjoint of a QRCP tail solves with A^T = P R^T Q^T
            if trans and kind == "qrcp":
                Z = np.linalg.solve(ds.R[:r, :r].T, B[ds.jpvt[:r]])
                ref = ds.Q[:, :r] @ Z
                old = np.abs(ds.Q[:, :r + 1] @ np.linalg.solve(
                    ds.R[:r + 1, :r + 1].T, B[ds.jpvt[:r + 1]])).max()
            else:
                ref = truncated_host_solve(ds, B, r)
                old = np.abs(truncated_host_solve(ds, B, r + 1)).max()
            dh = rel_diff(X, torch.as_tensor(ref, device="cuda"))
            what = f"{kind} {'adjoint' if trans else 'forward'}"
            xmax = float(X.abs().max())
            log(f"  rank rule {what}, rank {r} of {nm}: r = {r + 1} against "
                f"r = 0 {d0:.3e} (tol 1e-12), against the host's rank-{r} "
                f"solve {dh:.3e} (tol 1e-10); max|X| {xmax:.3e}, keeping "
                f"{r + 1} columns would give {old:.3e}")
            gate(d0 <= 1e-12 and dh <= 1e-10, f"rank rule {what}: {d0:.3e} "
                 f"/ {dh:.3e}")
            out[f"rank rule {what}"] = dict(vs_r0=d0, vs_host=dh, max_x=xmax,
                                            rank_plus_one_columns=float(old))
    return out


# BASELINE config 2: poisson2d(1024), n = 1,048,576, at BASELINE's batch
MILLION_NX = 1024
MILLION_NRHS = 64


def schedule_counts(dp) -> list:
    """Per level of a pack: each triangular factor's form and, for a level
    schedule, its levels, slots (rows and partial sums), chunk, dependency
    width K and stored entries (slots x K); the E and F entries."""
    from hifir_tpu_torch.ops.trsv import TrsvBlockDense, TrsvSchedule

    out = []
    for lv in dp.levels:
        row = dict(E_nnz=int(lv.E.nnz), F_nnz=int(lv.F.nnz))
        for name, f in (("L", lv.L), ("U", lv.U)):
            if isinstance(f, TrsvSchedule):
                K = int(f.cols.shape[2])
                row[name] = dict(form="schedule", n=f.n, levels=f.nlevels,
                                 slots=f.nchunks * f.chunk, chunk=f.chunk,
                                 K=K, entries=f.nchunks * f.chunk * K)
            elif isinstance(f, TrsvBlockDense):
                row[name] = dict(form="blocked_inverse", n=f.n,
                                 blocks=len(f.invs), W=f.W)
            else:
                row[name] = dict(form="dense_inverse", n=f.n)
        out.append(row)
    return out


def k2_breakdown(torch, dp, B, smi) -> list:
    """K2 alone on each level schedule of pack ``dp`` (CUDA events, 5
    back-to-back launches after a warm-up) at the block's width and at one
    column: ms, µs a level step and ns a stored dependency."""
    from hifir_tpu_torch.ops import trsv

    out = []
    for i, lv in enumerate(dp.levels):
        for name, S in (("L", lv.L), ("U", lv.U)):
            if not isinstance(S, trsv.TrsvSchedule) or not S.nchunks:
                continue
            K = int(S.cols.shape[2])
            entries = S.nchunks * S.chunk * K
            row = dict(level=i, factor=name, levels=S.nlevels,
                       slots=S.nchunks * S.chunk, K=K, entries=entries)
            for nrhs in (B.shape[1], 1):
                Bs = B[:S.n, :nrhs].contiguous()
                ms = timed(torch, lambda: trsv.trsv_apply_mrhs(S, Bs), 5)
                row[f"ms_nrhs{nrhs}"] = ms
                row[f"us_per_level_nrhs{nrhs}"] = ms * 1e3 / S.nlevels
                row[f"ns_per_dep_nrhs{nrhs}"] = ms * 1e6 / entries
            out.append(row)
            log(f"  K2 alone, level {i} {name} ({S.nlevels} levels, "
                f"{row['slots']} slots, K {K}): "
                + ", ".join(f"{row[f'ms_nrhs{r}']:.4f} ms "
                            f"({row[f'us_per_level_nrhs{r}']:.2f} us a "
                            f"level, {row[f'ns_per_dep_nrhs{r}']:.3f} ns a "
                            f"dependency) at {r} RHS"
                            for r in (B.shape[1], 1)) + f" [{smi}]")
    return out


def robust_cell(torch, rng, smi, A, name, tag, nrhs, adjoint=False):
    """One robust-configuration cell on the card, from the matrix ``A``
    (named ``name``; its report keys start with ``tag``): the port's native
    factorize with ``Options(verbose=0)`` (seconds with the host CPU,
    levels, tail, fill), packs ``auto`` in f32 and f64 (seconds, bytes by
    operand, schedule counts; with ``adjoint`` the f64 adjoint pack), the
    device M-solve at ``nrhs`` and at 1 RHS in both dtypes (with
    ``adjoint`` the f64 adjoint at ``nrhs`` too) against the host's native
    f64 single-RHS solves of 8 columns spread over the block (1e-4 / 1e-10
    of max|X|; the host's 2-D ``solve_mrhs`` takes tens of seconds at these
    sizes), K1 and K2 launches per solve from the packs' forms, the solves'
    CUDA-event times beside the host single-RHS solve (bench.py's
    baseline), K2 alone on each schedule, a torch.profiler breakdown of the
    ``nrhs`` f32 solve, and gmres_hif with a sliced-ELL A and the device M
    (f64) against the host gmres_np with the host M (restart 30, rtol 1e-6,
    one RHS: flag 0, true residual within 1.01 rtol, counts within one).
    Returns the report, the launches of each part, what each must be, the
    host factorization, the packs, the block B on the card and A as sliced
    ELL."""
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.ops.spmv import sliced_ell_from_csr
    from hifir_tpu_torch.solvers.gmres_np import gmres_hif as host_gmres

    launches, want, report = {}, {}, {}
    cpu = cpu_model()
    n = A.nrows
    t0 = time.perf_counter()
    P = ht.HIF().factorize(A, ht.Options(verbose=0))
    secs = time.perf_counter() - t0
    lv = [(p.m, p.n) for p in P.precs]
    last = P.precs[-1]
    tail = None if last.dense_matrix is None else last.dense_matrix.shape[0]
    kind = None if tail is None else last.dense_solver.kind
    rank = None if tail is None else last.dense_solver.rank
    report["factorize"] = dict(
        seconds=secs, cpu=cpu, levels=lv, nnz_M=P.nnz(), nnz_A=A.nnz,
        fill=P.nnz() / A.nnz, nnz_A_per_s=A.nnz / secs, tail=tail,
        tail_kind=kind, tail_rank=rank)
    log(f"  factorize {name} (native, Options(verbose=0)): n={n} "
        f"nnz(A)={A.nnz}; {secs:.2f} s ({A.nnz / secs / 1e6:.3f} Mnnz(A)/s) "
        f"on the host ({cpu}); levels {lv}, tail {tail} {kind} rank {rank}, "
        f"nnz(M)={P.nnz()}, fill {P.nnz() / A.nnz:.4f} [{smi}]")

    # the host reference: single-RHS native solves of 8 columns spread
    # over the block, each timed: bench.py's baseline
    B = rng.standard_normal((n, nrhs))
    cols = np.linspace(0, nrhs - 1, 8).astype(int)
    ref, host = {}, []
    for trans in (False, True) if adjoint else (False,):
        r = []
        for c in cols:
            t0 = time.perf_counter()
            r.append(P.solve(B[:, c], trans=trans))
            host.append(time.perf_counter() - t0)
        ref[trans] = np.stack(r, axis=1)
    report["host_solve_ms"] = [t * 1e3 for t in host]
    log(f"  host native f64 M-solve at 1 RHS (bench.py's baseline): "
        f"{min(host) * 1e3:.2f} ms, min of {len(host)} "
        f"({', '.join(f'{t * 1e3:.1f}' for t in host)}), on the host "
        f"({cpu}) [{smi}]")

    packs = {}
    for npdt in (np.float32, np.float64):
        dt = np.dtype(npdt).name
        t0 = time.perf_counter()
        packs[dt] = dp = P.to_device(dtype=npdt)
        torch.cuda.synchronize()
        psecs = time.perf_counter() - t0
        t0 = time.perf_counter()
        if adjoint and dt == "float64":
            dp.pack_transpose(P.precs)
            torch.cuda.synchronize()
        tsecs = time.perf_counter() - t0
        nb = pack_bytes(torch, dp)
        report[f"pack {dt}"] = dict(
            seconds=psecs, bytes=nb["forward"],
            total_bytes=sum(nb["forward"].values()),
            transpose_seconds=tsecs if "adjoint" in nb else None,
            adjoint_bytes=nb.get("adjoint"))
        log(f"  pack dense_inv=auto {dt}: {psecs:.2f} s (host); "
            f"{sum(nb['forward'].values())} bytes on the card, by operand "
            f"{nb['forward']}"
            + (f"; pack_transpose {tsecs:.2f} s, adjoint bytes "
               f"{nb['adjoint']}" if "adjoint" in nb else "") + f" [{smi}]")
    report["schedules"] = schedule_counts(packs["float32"])
    for i, row in enumerate(report["schedules"]):
        log(f"  level {i}: L {row['L']}, U {row['U']}, nnz(E) "
            f"{row['E_nnz']}, nnz(F) {row['F_nnz']}")

    Bd = {dt: torch.as_tensor(B, dtype=getattr(torch, dt), device="cuda")
          for dt in packs}
    bd = {dt: X[:, 0].contiguous() for dt, X in Bd.items()}
    runs = {}
    for dt, dp in packs.items():
        runs[f"{tag} {dt} nrhs={nrhs}"] = (
            lambda dp=dp, dt=dt: dp.solve_mrhs(Bd[dt]), False, cols)
        runs[f"{tag} {dt} nrhs=1"] = (
            lambda dp=dp, dt=dt: dp.solve(bd[dt]), False, None)
    if adjoint:
        runs[f"{tag} float64 adjoint nrhs={nrhs}"] = (
            lambda: packs["float64"].solve_mrhs(Bd["float64"], trans=True),
            True, cols)
    for key, (run, trans, cs) in runs.items():
        dp = packs[key.split()[1]]
        X = count_launches(torch, launches, key, run)
        gate(bool(torch.isfinite(X).all()), f"{key}: non-finite")
        shape = (n,) if cs is None else (n, nrhs)
        gate(tuple(X.shape) == shape, f"{key}: shape {tuple(X.shape)}")
        r = ref[trans] if cs is not None else ref[trans][:, 0]
        X = X if cs is None else X[:, torch.as_tensor(cs, device=X.device)]
        d = float(np.abs(X.double().cpu().numpy() - r).max()
                  / np.abs(r).max())
        tol = 1e-4 if "float32" in key else 1e-10
        forms = ([(t.LT, t.UT, t.FT, t.ET) for t in dp.tran] if trans
                 else [(v.L, v.U, v.E, v.F) for v in dp.levels])
        want[key] = want_launches(forms)
        report[key] = dict(rel_diff=d, tol=tol)
        log(f"  M-solve {key:30s}: rel diff vs host native f64 {d:.3e} "
            f"({'column 0' if cs is None else f'columns {cs.tolist()}'}) "
            f"(tol {tol:.0e}); launches {launches[key]}, by the pack's "
            f"forms {want[key]}")
        gate(d <= tol, f"{key}: {d:.3e} > {tol}")
    for key, (run, _, _) in runs.items():
        k = int(key.rsplit("=", 1)[1])
        ms = timed(torch, run, 5)
        report[key].update(ms=ms, us_per_rhs=ms * 1e3 / k)
        log(f"  {key:30s}: {ms:.4f} ms, {ms * 1e3 / k:.2f} us/RHS [{smi}]")
    report["k2_schedules"] = k2_breakdown(torch, packs["float32"],
                                          Bd["float32"], smi)
    key = f"{tag} float32 nrhs={nrhs}"
    report["profile"] = device_profile(torch, runs[key][0], 3)
    log_profile(key, report["profile"], report[key]["ms"])
    log(f"  device busy share of the {key} solve: "
        f"{report['profile']['busy_share']} [{smi}]")

    # gmres_hif with the device M (f64) against the host gmres_np with the
    # host M, on the same A and b
    As = sliced_ell_from_csr(A, device="cuda")
    b = B[:, 0]
    key = f"{tag} gmres_hif"
    t0 = time.perf_counter()
    x, flag, it = count_launches(torch, launches, key, lambda: ht.gmres_hif(
        As, packs["float64"], b, restart=30, rtol=1e-6))
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, flag_h, it_h = host_gmres(A, P, b, restart=30, rtol=1e-6)
    secs_h = time.perf_counter() - t0
    res = float(np.linalg.norm(b - A.matvec(x.cpu().numpy()))
                / np.linalg.norm(b))
    report["gmres"] = dict(flag=flag, iterations=it, seconds=secs,
                           host_flag=flag_h, host_iterations=it_h,
                           host_seconds=secs_h, true_rel_residual=res)
    log(f"  gmres_hif (sliced-ELL A, device M f64, restart 30, rtol 1e-6): "
        f"flag {flag}, {it} iterations, {secs * 1e3:.2f} ms (host clock), "
        f"true relative residual {res:.3e}; host gmres_np with the host M: "
        f"flag {flag_h}, {it_h} iterations, {secs_h:.2f} s; launches "
        f"{launches[key]} [{smi}]")
    gate(flag == 0 and flag_h == 0, f"{key}: flags {flag} / {flag_h}")
    gate(res <= 1.01e-6, f"{key}: true residual {res:.3e}")
    gate(abs(it - it_h) <= 1, f"{key}: {it} iterations against the host's "
         f"{it_h}")
    gate(launches[key]["K1"] > 0 and launches[key]["K2"] > 0,
         f"{key}: launches {launches[key]}")
    return report, launches, want, P, packs, Bd, As


def check_launches(launches, want) -> None:
    """Every counted part made the launches its packs' forms call for."""
    for key, w in want.items():
        for k, v in w.items():
            gate(launches[key][k] == v, f"{key}: {launches[key][k]} {k} "
                 f"launches, expected {v}")


def million_phase(torch, rng, smi):
    """BASELINE config 2 on the card: :func:`robust_cell` on poisson2d(1024)
    at 64 RHS, then HIFIR nirs = 4 in f64 with A as sliced ELL (the
    residual falls every step for every column).  Returns the report, the
    launches of each part and what each must be."""
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.models.problems import poisson2d
    from hifir_tpu_torch.ops.spmv import sliced_ell_sub_mrhs

    report, launches, want, P, packs, Bd, As = robust_cell(
        torch, rng, smi, poisson2d(MILLION_NX), f"poisson2d({MILLION_NX})",
        "1M", MILLION_NRHS)
    per = want_launches([(v.L, v.U, v.E, v.F) for v in
                         packs["float64"].levels])

    # HIFIR nirs = 4, f64, A = sliced ELL: K1 carries the residuals
    dp, Bt = packs["float64"], Bd["float64"]
    Xs = [ht.ir_apply(As, dp, Bt, k) for k in range(1, 4)]
    Xs.append(count_launches(torch, launches, "1M hifir nirs=4 float64",
                             lambda: ht.ir_apply(As, dp, Bt, 4)))
    want["1M hifir nirs=4 float64"] = dict(K7=0, K1=4 * per["K1"] + 3,
                                           K2=4 * per["K2"])
    rn = np.array([torch.linalg.vector_norm(sliced_ell_sub_mrhs(As, Xk, Bt),
                                            dim=0).cpu().numpy()
                   for Xk in Xs])
    rel = rn / torch.linalg.vector_norm(Bt, dim=0).cpu().numpy()
    report["hifir rel residual"] = list(map(float, rel.max(axis=1)))
    log(f"  HIFIR poisson2d({MILLION_NX}) (sliced-ELL A, f64, "
        f"{MILLION_NRHS} RHS) max relative "
        "residual per step: " + ", ".join(f"{v:.3e}" for v in
                                          rel.max(axis=1))
        + f"; launches {launches['1M hifir nirs=4 float64']}")
    gate(bool(np.all(rn[1:] < rn[:-1])), "1M HIFIR residual did not fall "
         "at every step for every column")
    ms = timed(torch, lambda: ht.ir_apply(As, dp, Bt, 4), 2)
    report["hifir_ms"] = ms
    log(f"  HIFIR nirs=4 f64, {MILLION_NRHS} RHS: {ms:.4f} ms an apply "
        f"[{smi}]")
    check_launches(launches, want)
    return report, launches, want


def saddle_phase(torch, rng, smi):
    """bench.py's correctness leg on the card: the port's native factorize
    of saddle_point_stokes(64) (n = 5120, robust options), packed in f32,
    then 10 Richardson steps x += M^{-1}(b - A x) with the residual in f64
    on the host and the M-solve on the card; the median contraction of the
    first 5 steps must be below 0.5 (bench.py's threshold, a gate here).
    Returns the report, the launches of the 10 steps and what they must
    be."""
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.models.problems import saddle_point_stokes

    A = saddle_point_stokes(64)
    n = A.nrows
    t0 = time.perf_counter()
    P = ht.HIF().factorize(A, ht.Options(verbose=0))
    secs = time.perf_counter() - t0
    dp = P.to_device(dtype=np.float32)
    b = rng.standard_normal(n)
    rn = [float(np.linalg.norm(b))]

    def steps():
        x = np.zeros(n)
        for _ in range(10):
            r = torch.as_tensor((b - A.matvec(x))[:, None],
                                dtype=torch.float32, device="cuda")
            x = x + dp.solve_mrhs(r)[:, 0].double().cpu().numpy()
            rn.append(float(np.linalg.norm(b - A.matvec(x))))
        return x

    launches = {}
    count_launches(torch, launches, "saddle IR", steps)
    per = want_launches([(v.L, v.U, v.E, v.F) for v in dp.levels])
    want = {"saddle IR": {k: 10 * v for k, v in per.items()}}
    ratios = [rn[i + 1] / rn[i] for i in range(10) if rn[i] > 0]
    contraction = float(np.median(ratios[:5]))
    report = dict(seconds=secs, levels=[(p.m, p.n) for p in P.precs],
                  nnz_M=P.nnz(), residuals=rn, contraction=contraction)
    log(f"  saddle_point_stokes(64): factorize {secs:.2f} s (native), "
        f"levels {report['levels']}; mixed f32-M / f64-residual IR: "
        f"residual {rn[-1] / rn[0]:.3e} of |b| after 10 steps, median "
        f"contraction of the first 5 {contraction:.4f} (gate < 0.5); "
        f"launches {launches['saddle IR']}, by the pack's forms "
        f"{want['saddle IR']}")
    gate(contraction < 0.5, f"saddle-point IR contraction {contraction:.3f}")
    for k, v in want["saddle IR"].items():
        gate(launches["saddle IR"][k] == v, f"saddle IR: "
             f"{launches['saddle IR'][k]} {k} launches, expected {v}")
    return report, launches, want


# ---------------------------------------------------------------------------
# distribution: eight ranks on one card

DIST_NX = 512          # the JAX package's DistPrec scale leg
DIST_CHUNK = 1024
DIST_RANKS = 8
SWEEP_WIDE_RANKS = (16, 17, 32)
RED_OPTS = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5,
                kappa_d=5, verbose=0, dense_thres=50)


def dist_counters():
    from hifir_tpu_torch.ops import chunk
    from hifir_tpu_torch.parallel import schur

    return {"K10a": chunk.ChunkSweep, "sweep": chunk.ChunkSweepKernel,
            "K10b": schur.schur_partial_cuda}


def dist_reset():
    reset_counts()
    for f in dist_counters().values():
        f.launches = 0


def dist_read():
    out = read_counts()
    out.update({k: f.launches for k, f in dist_counters().items()})
    return out


def dist_plain_calls() -> int:
    from hifir_tpu_torch.ops import chunk
    from hifir_tpu_torch.parallel import schur

    return (plain_calls() + chunk.chunk_fma_plain.calls
            + chunk.chunk_sweep_plain.calls + schur.schur_partial_plain.calls)


def dist_count(torch, launches, what, fn):
    """``fn()`` with every launch count (K10a, the sweep and K10b too) and
    the plain versions' calls set to 0 just before it and read just after;
    a plain call on the card fails the run."""
    from hifir_tpu_torch.ops import chunk, spmv, trsv
    from hifir_tpu_torch.ops.bsr_spmv import bsr_matvec_mrhs_plain
    from hifir_tpu_torch.parallel import schur

    for f in (chunk.chunk_fma_plain, chunk.chunk_sweep_plain,
              schur.schur_partial_plain, spmv.sliced_ell_sub_mrhs_plain,
              trsv.trsv_apply_plain, bsr_matvec_mrhs_plain):
        f.calls = 0
    torch.cuda.synchronize()
    dist_reset()
    out = fn()
    torch.cuda.synchronize()
    launches[what] = dist_read()
    plain = dist_plain_calls()
    gate(plain == 0, f"{what}: {plain} plain-version calls on the card")
    return out


def dist_solve_factors(dp) -> dict:
    """What carries each factor of a DistPrec and the chunks of one solve
    (each factor runs twice, down and up)."""
    from hifir_tpu_torch.parallel.trsv_halo import HaloOp

    kinds = [type(op).__name__ for lv in dp.levels
             for op in (lv.L_op, lv.U_op) if op.nchunks]
    return dict(factors=len(kinds), halo_factors=kinds.count(HaloOp.__name__),
                ag_factors=kinds.count("AGTrsvOp"),
                chunks_per_solve=2 * sum(op.nchunks for lv in dp.levels
                                         for op in (lv.L_op, lv.U_op)),
                xin_levels=sum(lv.xin is not None for lv in dp.levels))


def sweep_gates(per: dict, shape: dict, what: str) -> None:
    """On the one-group mesh every factor application is one sweep launch
    (each factor with chunks runs twice a solve, down and up) and no K10a
    launch runs."""
    gate(per["sweep"] == 2 * shape["factors"] and per["K10a"] == 0,
         f"{what}: {per['sweep']} sweep launches for {shape['factors']} "
         f"factors with chunks, {per['K10a']} K10a launches")


def k10a_gates(per: dict, shape: dict, ngroups: int, what: str) -> None:
    """On a mesh of several groups every chunk step is one K10a launch a
    group and no sweep runs."""
    gate(per["K10a"] == ngroups * shape["chunks_per_solve"]
         and per["sweep"] == 0,
         f"{what}: {per['K10a']} K10a launches, {per['sweep']} sweeps for "
         f"{shape['chunks_per_solve']} chunk steps of {ngroups} groups")


def sweep_bytes(sw, es: int) -> tuple:
    """What one application of a sweep must move, and its entries: each
    live entry's index and value once, each x entry it reads once (a
    rank's distinct dependencies and its own slots), and each slot written
    once a rank copy (halo form: the own slots and the legs' receivers)."""
    R, cloc = sw.ranks, sw.cloc
    keys, nnz = [], 0
    if sw.form == "all_gather":
        cols, vals = sw.cols.cpu().numpy(), sw.vals.cpu().numpy()
        live = vals != 0
        rk = np.broadcast_to(np.arange(R)[None, :, None, None], cols.shape)
        keys.append(rk[live].astype(np.int64) * sw.min_len + cols[live])
        own = sw.nchunks * sw.chunk
        written = own * R
    else:
        written = 0
        for c in range(sw.nchunks):
            cols, vals, _ = (t.cpu().numpy() for t in sw.halo_chunk(c))
            live = vals != 0
            rk = np.broadcast_to(np.arange(R)[:, None, None], cols.shape)
            keys.append(rk[live].astype(np.int64) * sw.min_len + cols[live])
            _, Wl, _, Wr, _, Wag = sw.desc_host[c, 3:9].tolist()
            written += (Wl + Wr) * (R - 1) + Wag * R * R
        own = sw.nchunks * cloc * R
        written += own
    nnz = sum(k.size for k in keys)
    uniq = np.unique(np.concatenate(keys)).size
    return nnz * (4 + es) + (uniq + own) * es + written * es, nnz


def sweep_pair(torch, rng, op, dt):
    """One application of factor ``op``'s chunk sweep (its one-group plan)
    by the kernel and by ``chunk_sweep_plain`` on the same slot vectors:
    random own slots, the halo regions and the zero slot zero.  Returns the
    sweep, the entry vectors and both results."""
    from hifir_tpu_torch.ops import chunk
    from hifir_tpu_torch.parallel.trsv_halo import HaloOp

    halo = isinstance(op, HaloOp)
    sw = op.packed[0] if halo else op.plan
    gate(sw is not None, "the factor has no sweep plan (several groups)")
    own = op.own_len if halo else op.nslots
    x0 = torch.zeros((sw.ranks, sw.min_len), dtype=dt, device=sw.vals.device)
    x0[:, :own] = randn_on(torch, rng, (sw.ranks, own), dt)
    xk, xp = x0.clone(), x0.clone()
    chunk.chunk_sweep(xk, sw)
    chunk.chunk_sweep_plain(xp, sw)
    torch.cuda.synchronize()
    return sw, x0, xk, xp


def sweep_row(torch, book, rng, dp, lvl, Th, name):
    """The chunk sweep (K10a redesigned): one application of level
    ``lvl``'s L factor of ``dp`` (factor ``Th``) on every rank, one launch,
    against ``chunk_sweep_plain`` on the same slot vectors.  The library
    call is ``torch.triangular_solve`` with the factor as CSR on one copy
    (as K2's row), held against the factor's distributed solve of the same
    right-hand side."""
    import scipy.sparse as sp

    from hifir_tpu_torch.ops import chunk
    from hifir_tpu_torch.parallel.prec_sharded import _trsv_op_kernel

    op = dp.levels[lvl].L_op
    dt = dp.dtype
    dname = str(dt).removeprefix("torch.")
    es = torch.empty((), dtype=dt).element_size()
    sw, x0, xk, xp = sweep_pair(torch, rng, op, dt)
    tol, stol = (1e-12, 1e-10) if dt == torch.float64 else (1e-5, 1e-4)
    Ts = sp.tril(Th.to_scipy().tocsr(), -1).tocsr()
    Tcsr = csr_tensor(torch, (Ts + sp.eye(op.n, format="csr")).tocsr()
                      .sorted_indices(), dt, sw.vals.device)
    b = randn_on(torch, rng, (op.n, 1), dt)
    ref = _trsv_op_kernel(op, dp.mesh.replicate(b[:, 0]))[0][0][:, None]
    lib = book.library(
        f"{name} {dname} level-{lvl} L torch.triangular_solve (CSR)",
        lambda: torch.triangular_solve(b, Tcsr, upper=False,
                                       unitriangular=True)[0], ref, stol)
    nbytes, nnz = sweep_bytes(sw, es)
    xw, xq = x0.clone(), x0.clone()
    ms = book.T.ms(lambda: chunk.chunk_sweep(xw, sw))
    plain_ms = book.T.ms(lambda: chunk.chunk_sweep_plain(xq, sw), iters=3,
                         warmup=1)
    K = (sw.cols.shape[3] if sw.form == "all_gather"
         else int(sw.desc_host[:, 1].max()))
    book.record(name, dname,
                f"ranks={sw.ranks} chunks={sw.nchunks} cloc={sw.cloc} K={K} "
                f"nnz={nnz} slots={sw.min_len} form={sw.form} level={lvl} L "
                f"stages={sw._kernel.stages} smem={sw._kernel.smem}",
                xk, xp, ms, plain_ms, lib, nbytes, 2.0 * nnz, tol,
                simt_peak(dt))


def k10a_row(torch, book, rng, dp):
    """K10a at the shape the several-group layout gives it: the chunk of
    the first all_gather L factor (level 0 on the main path) with the most
    dependency entries in group 0, on that group's ranks at once, against
    the plain version, with torch.sparse.mm of the chunk's rows
    (rank-offset columns over the ranks' stacked buffers) as the library
    call computing the same contributions."""
    import scipy.sparse as sp

    from hifir_tpu_torch.ops import chunk
    from hifir_tpu_torch.parallel.prec_sharded import AGTrsvOp

    lvl, op = next((i, lv.L_op) for i, lv in enumerate(dp.levels)
                   if isinstance(lv.L_op, AGTrsvOp) and lv.L_op.nchunks)
    gate(op.plan is None, "K10a row: the factor runs the sweep (one group)")
    dt = dp.dtype
    dname = str(dt).removeprefix("torch.")
    es = torch.empty((), dtype=dt).element_size()
    g = dp.mesh.groups()[0]
    nnzs = [int((op.vals[0][c] != 0).sum()) for c in range(op.nchunks)]
    c = int(np.argmax(nnzs))
    cols, vals = op.cols[0][c], op.vals[0][c]
    R, cloc, K = cols.shape
    L, out_off, out_step = op.nslots + 1, c * op.chunk + g.lo * cloc, cloc
    x0 = randn_on(torch, rng, (R, L), dt)
    x0[:, -1] = 0
    xk, xp = x0.clone(), x0.clone()
    chunk.ChunkSweep(xk)(cols, vals, out_off, out_step)
    chunk.chunk_fma_plain(xp, cols, vals, out_off, out_step)
    pos = (out_off + out_step * torch.arange(R, device=x0.device)[:, None]
           + torch.arange(cloc, device=x0.device))
    Y, Yp = xk.gather(1, pos), xp.gather(1, pos)
    # the library call: the contributions as one CSR product
    cc, vv = cols.cpu().numpy(), vals.cpu().numpy()
    live = vv != 0
    r, j, _ = np.nonzero(live)
    A = sp.csr_matrix((vv[live], (r * cloc + j, r * L + cc[live])),
                      shape=(R * cloc, R * L))
    Acsr = csr_tensor(torch, A, dt, x0.device)
    contrib = x0.gather(1, pos) - Y
    nnz = int(live.sum())
    xw = x0.clone()
    sweep = chunk.ChunkSweep(xw)
    ms = book.T.ms(lambda: sweep(cols, vals, out_off, out_step))
    plain_ms = book.T.ms(lambda: chunk.chunk_fma_plain(
        xw, cols, vals, out_off, out_step))
    lib = book.library(
        f"K10a {dname} all_gather chunk torch.sparse.mm",
        lambda: torch.sparse.mm(Acsr, x0.reshape(-1, 1)).view(R, cloc),
        contrib, 1e-12 if dt == torch.float64 else 1e-5)
    # each entry's index and value once, each x entry it reads once, and
    # the chunk's slots read and written
    uniq = len({(a, b) for a, b in zip(r.tolist(), cc[live].tolist())})
    nbytes = nnz * (4 + es) + uniq * es + 2 * R * cloc * es
    book.record("K10a_chunk", dname,
                f"ranks={R} (group 0 of {len(dp.mesh.groups())}) "
                f"cloc={cloc} K={K} nnz={nnz} slots={L} form=all_gather "
                f"level={lvl} L chunk={c}", Y, Yp, ms, plain_ms, lib,
                nbytes, 2.0 * nnz, 1e-12 if dt == torch.float64 else 1e-5,
                simt_peak(dt))


# K10b beside the convdiff2d(128) level-0 shape (warp tier): one seeded
# shape in each wider tier, and the inputs that break sorts and scans, each
# through every tier whose range holds it.  (name, ranks, tail rows nm, U_F
# rows m, panel width cb, KL, KU, live share); W = KL * KU.
K10B_SHAPES = (("block", 8, 512, 4096, 512, 64, 64, 0.9),
               ("global", 8, 256, 4000, 1000, 160, 125, 0.9))
K10B_EDGES = (("w1", 8, 13, 4, 3, 1, 1, 1.0),
              ("w225", 8, 61, 40, 30, 15, 15, 0.8),
              ("w512", 8, 29, 60, 40, 32, 16, 0.9),
              ("w513", 8, 29, 40, 30, 27, 19, 0.9),
              ("long runs w200", 8, 61, 120, 2, 100, 2, 1.0),
              ("long runs w900", 8, 37, 400, 3, 300, 3, 1.0),
              ("long runs w16000", 8, 19, 4100, 4, 4000, 4, 1.0),
              ("all sentinel", 8, 61, 40, 30, 15, 15, 0.0))
K10B_TOL = {"float64": 1e-12, "float32": 1e-5}


def k10b_inputs(rng, D, nm, m, cb, KL, KU, live):
    """Seeded K10b operands as ``schur_spgemm_ring`` packs them (numpy,
    float64): D ranks of nb = ceil(nm / D) rows (rows past nm all sentinel,
    as the padded tail); an L_E row holds distinct U_F rows l < m, a
    binomial share ``live`` of its KL slots live, the rest the sentinel m
    with value 0; a U_F row up to KU distinct local columns below cb,
    ascending, pads cb with value 0 (row m all pads); d normal + 2, the
    sentinel's d 0.  (The CPU tests' generator,
    tests/test_torch_schur_kernel.py.)"""
    nb = -(-nm // D)

    def distinct(rows, k, hi):
        x = np.sort(rng.integers(0, hi - k + 1, size=(rows, k)), axis=1)
        return (x + np.arange(k)).astype(np.int32)

    le_i = np.full((D * nb, KL), m, dtype=np.int32)
    le_v = np.zeros((D * nb, KL))
    take = np.arange(KL) < rng.binomial(KL, live, size=(nm, 1))
    le_i[:nm] = np.where(take, rng.permuted(distinct(nm, KL, m), axis=1), m)
    le_v[:nm] = np.where(take, rng.standard_normal((nm, KL)), 0.0)
    uf_i = np.full((D, m + 1, KU), cb, dtype=np.int32)
    uf_v = np.zeros((D, m + 1, KU))
    keep = np.arange(KU) < rng.integers(0, KU + 1, size=(D * m, 1))
    uf_i[:, :m] = np.where(keep, distinct(D * m, KU, cb),
                           cb).reshape(D, m, KU)
    uf_v[:, :m] = np.where(keep, rng.standard_normal((D * m, KU)),
                           0.0).reshape(D, m, KU)
    d = np.append(rng.standard_normal(m) + 2.0, 0.0)
    return (le_i.reshape(D, nb, KL), le_v.reshape(D, nb, KL),
            np.broadcast_to(d, (D, m + 1)), uf_i, uf_v)


def k10b_run(torch, ops, cb, dt, what, tier=None):
    """K10b on numpy operands ``ops`` (le_idx, le_val, d, uf_idx, uf_val)
    in ``dt`` on the card, in ``tier`` (default: the plan's), against the
    plain version: columns and masks equal, values within K10B_TOL of the
    plain version's largest; a second launch bitwise equal to the first.
    Returns (card args, kernel values, plain values, the plan, the values'
    relative difference)."""
    from hifir_tpu_torch.parallel import schur

    t = lambda a, v=None: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a), dtype=v, device="cuda")
    args = (t(ops[0]), t(ops[1], dt), t(ops[2], dt), t(ops[3]),
            t(ops[4], dt))
    D, nb, KL = ops[0].shape
    W = KL * ops[3].shape[2]
    plan = schur.schur_plan(W, D * nb, args[1].element_size(),
                            torch.cuda.get_device_properties(0)
                            .multi_processor_count, cb, tier)
    kc, kv = schur.schur_partial_cuda(*args, cb, tier=tier)
    kc2, kv2 = schur.schur_partial_cuda(*args, cb, tier=tier)
    pc, pv = schur.schur_partial_plain(*args, cb)
    torch.cuda.synchronize()
    dname = str(dt).removeprefix("torch.")
    bits = torch.int64 if dt == torch.float64 else torch.int32
    gate(torch.equal(kc, kc2) and torch.equal(kv.view(bits), kv2.view(bits)),
         f"K10b {what} {dname} ({plan['tier']} tier): two launches differ")
    gate(torch.equal(kc, pc), f"K10b {what} {dname} ({plan['tier']} tier): "
         "the kernel's columns and masks differ from the plain version's")
    rel = rel_diff(kv, pv)
    gate(rel <= K10B_TOL[dname], f"K10b {what} {dname} ({plan['tier']} "
         f"tier): values {rel:.3e} from the plain version's")
    return args, kv, pv, plan, rel


def k10b_record(torch, book, ops, cb, dt, what):
    """K10b's row at numpy operands ``ops`` (every rank at once, the
    plan's tier): :func:`k10b_run`'s checks, then the kernel and the plain
    version timed beside the bound; no single PyTorch call computes it."""
    from hifir_tpu_torch.parallel import schur

    args, kv, pv, plan, _ = k10b_run(torch, ops, cb, dt, what)
    le_i, _, _, uf_i, _ = ops
    D, nb, KL = le_i.shape
    m, KU = uf_i.shape[1] - 1, uf_i.shape[2]
    W = KL * KU
    es = torch.empty((), dtype=dt).element_size()
    # what this step's data needs: each live L_E entry (index and value),
    # each U_F row (KU slots) and d entry that a live entry references, once
    # a rank, and the W outputs a row written; a product and a sum for each
    # live candidate, a product for each l * d
    li = le_i.reshape(D, nb * KL)
    rk, slot = np.nonzero(li != m)
    used = np.unique(rk.astype(np.int64) * (m + 1) + li[rk, slot])
    n_cand = int((uf_i[rk, li[rk, slot]] != cb).sum())
    nbytes = (rk.size * (4 + es) + used.size * (es + KU * (4 + es))
              + D * nb * W * (4 + es))
    flops = rk.size + 2 * n_cand
    book.record("K10b_schur", str(dt).removeprefix("torch."),
                f"{what} tier={plan['tier']} P={plan['P']} ranks={D} "
                f"nb={nb} KL={KL} KU={KU} W={W} m={m} cb={cb} "
                f"live_le={rk.size} uf_rows={used.size} "
                f"candidates={n_cand}", kv, pv,
                book.T.ms(lambda: schur.schur_partial(*args, cb)),
                book.T.ms(lambda: schur.schur_partial_plain(*args, cb),
                          iters=5),
                (None, "no single PyTorch call computes it"), nbytes, flops,
                K10B_TOL[str(dt).removeprefix("torch.")], simt_peak(dt))


def k10b_row(torch, book, rec, mesh, dt):
    """K10b at the largest level's ring-step shape of the dist_schur
    factorize (``rec``: that level's C, L_E, d, U_F), every rank at once,
    in ``dt``, against the plain version."""
    from hifir_tpu_torch.parallel import schur

    C, L_E, d, U_F = rec
    D = mesh.D
    nm, m = L_E.nrows, L_E.ncols
    nmp = -(-nm // D) * D
    nb = cb = nmp // D
    le_i, le_v, KL = schur._ell_pack(L_E, nmp, sentinel=m)
    uf_i, uf_v, KU = schur._panelize_uf(U_F, D, cb)
    d_ext = np.concatenate([np.asarray(d), [0.0]])
    ops = (le_i.reshape(D, nb, KL), le_v.reshape(D, nb, KL),
           np.broadcast_to(d_ext, (D, m + 1)), uf_i, uf_v)
    k10b_record(torch, book, ops, cb, dt, f"convdiff2d(128) nm={nm}")


def k10b_tiers(torch, book, rng, dt) -> list:
    """K10b's seeded shapes of the wider tiers (rows of ``book``), and the
    edge cases of K10B_EDGES through every tier whose range holds them;
    returns the edge cases' records."""
    from hifir_tpu_torch.parallel.schur import _P_RANGE, SCHUR_TIERS

    dname = str(dt).removeprefix("torch.")
    for name, D, nm, m, cb, KL, KU, live in K10B_SHAPES:
        k10b_record(torch, book, k10b_inputs(rng, D, nm, m, cb, KL, KU,
                                             live), cb, dt, f"seeded {name}")
    recs = []
    for name, D, nm, m, cb, KL, KU, live in K10B_EDGES:
        ops = k10b_inputs(rng, D, nm, m, cb, KL, KU, live)
        for tier in SCHUR_TIERS:
            if KL * KU > (_P_RANGE[tier][1] or KL * KU):
                continue
            plan, rel = k10b_run(torch, ops, cb, dt, name, tier)[3:]
            recs.append(dict(name=name, dtype=dname, W=KL * KU, tier=tier,
                             P=plan["P"], rel_err=rel))
    log(f"  K10b {dname}: {len(recs)} edge runs equal to the plain version "
        f"(columns exactly, values within {K10B_TOL[dname]:.0e}), each "
        "launch twice bitwise: " + ", ".join(
            f"{r['name']}/{r['tier']} {r['rel_err']:.1e}" for r in recs))
    return recs


def randn_on(torch, rng, shape, dt):
    return torch.as_tensor(rng.standard_normal(shape), dtype=dt,
                           device="cuda")


def dist_phase(torch, T, rng, smi, k10b_seed=0):
    """Distribution (``hifir_tpu_torch/parallel``) on eight ranks of one
    card, each part counted: DistPrec at the JAX package's scale leg (one
    group: the sweep; two groups of the card: K10a a chunk), the halo and
    exchange paths at full depth (also on two groups, and the sweep's wider
    clusters of 16, 17 and 32 ranks), the sharded IR step, the ring Schur
    and dist_schur=1, and PartitionedHIF with a DistPrec a part.  Returns
    the report, the launches of each part and the kernel rows."""
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.models.problems import convdiff2d, poisson2d
    from hifir_tpu_torch.ops.spmv import (sliced_ell_from_csr,
                                          sliced_ell_sub_mrhs)
    from hifir_tpu_torch.parallel import (DistPrec, PartitionedHIF,
                                          build_halo_spmv, halo_spmv,
                                          make_mesh, make_sharded_ir_step,
                                          shard_ell_rows, sharded_spmv)
    from hifir_tpu_torch.parallel import schur as pschur
    from hifir_tpu_torch.parallel.trsv_halo import HaloOp

    dev = "cuda"
    launches, report = {}, {}
    book = Rows(T)
    mesh = make_mesh(DIST_RANKS, device=dev)
    log(f"  mesh: {mesh.shape} on {dev} ({len(mesh.groups())} group) "
        f"[{smi}]")

    # 1. DistPrec at the scale leg: poisson2d(512), robust options
    t_part = time.perf_counter()
    A = poisson2d(DIST_NX)
    n = A.nrows
    t0 = time.perf_counter()
    P = ht.HIF().factorize(A, ht.Options(verbose=0), device=dev)
    fsecs = time.perf_counter() - t0
    lv = [(p.m, p.n) for p in P.precs]
    b = rng.standard_normal(n)
    xh = P.solve(b)
    xmax = np.abs(xh).max()
    single = P.to_device(dtype=np.float64, device=dev)
    xs = single.solve(b).cpu().numpy()
    rep = dict(n=n, levels=lv, factorize_seconds=fsecs, nnz_M=P.nnz())
    dps = {}
    for npdt, tol in ((np.float64, 1e-12), (np.float32, 1e-4)):
        name = np.dtype(npdt).name
        t0 = time.perf_counter()
        dp = dps[name] = DistPrec.from_host(
            mesh, P, dtype=npdt, chunk=DIST_CHUNK, max_halo_chunks=128)
        build = time.perf_counter() - t0
        shape = dist_solve_factors(dp)
        x = dist_count(torch, launches, f"distprec {name} solve",
                       lambda: dp.solve(b)).double().cpu().numpy()
        per = launches[f"distprec {name} solve"]
        err_h = float(np.abs(x - xh).max() / xmax)
        err_s = float(np.abs(x - xs).max() / xmax)
        gate(err_h <= tol, f"DistPrec {name} vs host solve {err_h:.3e}")
        gate(err_s <= tol, f"DistPrec {name} vs DevicePrec solve "
             f"{err_s:.3e}")
        sweep_gates(per, shape, f"DistPrec {name}")
        gate(per["K1"] > 0, "DistPrec: no K1 launch")
        ms = timed(torch, lambda: dp.solve(b), 3)
        prof = None
        if name == "float64":
            prof = device_profile(torch, lambda: dp.solve(b), 1,
                                  reset=dist_reset, read=dist_read)
            log_profile(f"DistPrec {name} solve", prof, ms)
        rep[name] = dict(build_seconds=build, **shape,
                         comm_elems=dp.comm_elems,
                         allgather_elems=dp.allgather_elems,
                         n_halo=dp.n_halo,
                         bytes_per_rank=dp.nbytes_per_rank(),
                         err_vs_host=err_h, err_vs_deviceprec=err_s,
                         solve_ms=ms, launches_per_solve=per, profile=prof)
        log(f"  DistPrec poisson2d({DIST_NX}) {name}: levels {lv}; build "
            f"{build:.2f} s (host); halo factors {shape['halo_factors']}, "
            f"all_gather factors {shape['ag_factors']}, exchange-linked "
            f"levels {shape['xin_levels']}; {shape['chunks_per_solve']} "
            f"chunks/solve; comm_elems {dp.comm_elems} vs allgather_elems "
            f"{dp.allgather_elems}; bytes/rank {dp.nbytes_per_rank()}; "
            f"rel err vs host {err_h:.3e}, vs DevicePrec {err_s:.3e} "
            f"(tol {tol:.0e}); solve {ms} ms (CUDA events); launches/solve "
            f"{per} [{smi}]")
    # K10a a chunk at the shape a mesh over several devices gives it: the
    # same solve on two groups of the one card ("cuda:0" and "cuda" are
    # distinct devices to the mesh, as "cpu" and "cpu:0" in the tests), four
    # ranks x 128 slots a group, the all_gather legs as copies between
    # launches
    mesh2 = make_mesh(devices=["cuda:0"] * 4 + ["cuda"] * 4)
    ngroups = len(mesh2.groups())
    gate(ngroups == 2, f"the split layout has {ngroups} groups")
    dps2 = {}
    for npdt, tol in ((np.float64, 1e-12), (np.float32, 1e-4)):
        name = np.dtype(npdt).name
        what = f"distprec {name} solve two groups"
        t0 = time.perf_counter()
        dp = dps2[name] = DistPrec.from_host(
            mesh2, P, dtype=npdt, chunk=DIST_CHUNK, max_halo_chunks=128)
        build = time.perf_counter() - t0
        shape = dist_solve_factors(dp)
        x = dist_count(torch, launches, what,
                       lambda: dp.solve(b)).double().cpu().numpy()
        per = launches[what]
        err_h = float(np.abs(x - xh).max() / xmax)
        gate(err_h <= tol, f"DistPrec {name}, two groups, vs host solve "
             f"{err_h:.3e}")
        k10a_gates(per, shape, ngroups, what)
        # timed in f64 only: the f32 run stands for its K10a row's shape
        ms = timed(torch, lambda: dp.solve(b), 1) if npdt == np.float64 \
            else None
        rep[f"{name} two groups"] = dict(**shape, build_seconds=build,
                                         err_vs_host=err_h, solve_ms=ms,
                                         launches_per_solve=per)
        log(f"  DistPrec poisson2d({DIST_NX}) {name} on two groups of one "
            f"card: build {build:.2f} s (host); rel err vs host {err_h:.3e} "
            f"(tol {tol:.0e}); solve {ms} ms (CUDA events); launches/solve "
            f"{per} [{smi}]")
    report["distprec"] = rep

    report["distprec"]["seconds"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # 2. the halo and exchange paths at full depth: poisson2d(64) with the
    # JAX distribution tests' options, chunk=64
    A64 = poisson2d(64)
    P64 = ht.HIF().factorize(A64, ht.Options(**RED_OPTS), device=dev)
    gate(P64.levels() >= 3, f"poisson2d(64): {P64.levels()} levels (< 3)")
    b64 = rng.standard_normal(A64.nrows)
    xh64 = P64.solve(b64)
    rep = dict(levels=[(p.m, p.n) for p in P64.precs])
    for form, kw in (("halo", {}), ("all_gather", dict(halo=False)),
                     ("whole vectors", dict(shard_vectors=False))):
        dp = DistPrec.from_host(mesh, P64, chunk=64, **kw)
        if form == "halo":
            dp64_halo = dp
        x = dist_count(torch, launches, f"p64 {form}",
                       lambda: dp.solve(b64)).cpu().numpy()
        err = float(np.abs(x - xh64).max() / np.abs(xh64).max())
        gate(err <= 1e-12, f"poisson2d(64) DistPrec {form}: {err:.3e}")
        shape = dist_solve_factors(dp)
        sweep_gates(launches[f"p64 {form}"], shape, f"poisson2d(64) {form}")
        rep[form] = dict(err=err, comm_elems=dp.comm_elems,
                         allgather_elems=dp.allgather_elems,
                         n_halo=dp.n_halo, **shape,
                         launches=launches[f"p64 {form}"])
        if form == "halo":
            gate(dp.comm_elems < 0.5 * dp.allgather_elems,
                 f"halo comm {dp.comm_elems} >= half of "
                 f"{dp.allgather_elems}")
            gate(dp.n_halo >= 4, f"{dp.n_halo} halo factors (< 4)")
            gate(all(lvl.xin is not None and lvl.xin.comm_elems
                     < lvl.xin.allgather_elems for lvl in dp.levels[1:]),
                 "an exchange plan is missing or not cheaper")
        if form == "whole vectors":
            gate(all(lvl.xin is None for lvl in dp.levels),
                 "an exchange plan without sharded vectors")
        log(f"  poisson2d(64) DistPrec {form}: rel err {err:.3e} (tol "
            f"1e-12); comm {dp.comm_elems} / allgather "
            f"{dp.allgather_elems}; halo factors {dp.n_halo}; launches "
            f"{launches[f'p64 {form}']}")
    # K10a a chunk in both forms: the same operator on the two groups
    for form, kw in (("halo", {}), ("all_gather", dict(halo=False))):
        what = f"p64 {form} two groups"
        dp = DistPrec.from_host(mesh2, P64, chunk=64, **kw)
        x = dist_count(torch, launches, what,
                       lambda: dp.solve(b64)).cpu().numpy()
        err = float(np.abs(x - xh64).max() / np.abs(xh64).max())
        shape = dist_solve_factors(dp)
        per = launches[what]
        gate(err <= 1e-12, f"poisson2d(64) DistPrec {form}, two groups: "
             f"{err:.3e}")
        k10a_gates(per, shape, ngroups, what)
        rep[f"{form} two groups"] = dict(err=err, **shape, launches=per)
        log(f"  poisson2d(64) DistPrec {form}, two groups of one card: rel "
            f"err {err:.3e} (tol 1e-12); launches {per}")
    # the sweep's wider clusters: 16 ranks (a non-portable cluster of 16
    # CTAs), 17 and 32 (two ranks a CTA, the last CTA of 17 with one)
    for R in SWEEP_WIDE_RANKS:
        meshR = make_mesh(R, device=dev)
        for form, kw in (("halo", {}), ("all_gather", dict(halo=False))):
            what = f"p64 {form} {R} ranks"
            dp = DistPrec.from_host(meshR, P64, chunk=64, **kw)
            x = dist_count(torch, launches, what,
                           lambda: dp.solve(b64)).cpu().numpy()
            err = float(np.abs(x - xh64).max() / np.abs(xh64).max())
            shape = dist_solve_factors(dp)
            gate(err <= 1e-12, f"poisson2d(64) DistPrec {form}, {R} ranks: "
                 f"{err:.3e}")
            sweep_gates(launches[what], shape, what)
            sw, _, xk, xp = sweep_pair(torch, rng, dp.levels[0].L_op,
                                       dp.dtype)
            serr = rel_diff(xk, xp)
            gate(serr <= 1e-12, f"{what}: the level-0 L sweep differs from "
                 f"its plain version by {serr:.3e}")
            rep[f"{form} {R} ranks"] = dict(
                err=err, sweep_vs_plain=serr, cloc=sw.cloc,
                stages=sw._kernel.stages, **shape, launches=launches[what])
            log(f"  poisson2d(64) DistPrec {form}, {R} ranks on one card: "
                f"rel err {err:.3e}; level-0 L sweep vs plain {serr:.3e} "
                f"(tol 1e-12; cloc {sw.cloc}); launches {launches[what]}")
    report["halo_paths"] = rep
    rep["seconds"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # 3. sharded and halo SpMV and the IR step on a (2, 4) mesh with
    # poisson2d(512)'s A
    mesh24 = make_mesh(DIST_RANKS, rhs=2, device=dev)
    Ae = shard_ell_rows(mesh24, A)
    Aw = sliced_ell_from_csr(A, dtype=np.float64, device=dev)
    xv = randn_on(torch, rng, (n,), torch.float64)
    yk = sliced_ell_sub_mrhs(Aw, xv[:, None])[:, 0]
    ys = dist_count(torch, launches, "sharded_spmv",
                    lambda: sharded_spmv(mesh24, Ae, xv))[:n]
    H = build_halo_spmv(mesh, A)
    xpad = torch.zeros(H.nb * DIST_RANKS, dtype=torch.float64, device=dev)
    xpad[:n] = xv
    yh = dist_count(torch, launches, "halo_spmv",
                    lambda: halo_spmv(H, xpad))[:n]
    e_s, e_h = rel_diff(ys, yk), rel_diff(yh, yk)
    gate(e_s <= 1e-12 and e_h <= 1e-12, f"sharded/halo SpMV vs K1 on A: "
         f"{e_s:.3e} / {e_h:.3e}")
    step = make_sharded_ir_step(mesh24, n)
    nrhs = 4
    B = randn_on(torch, rng, (Ae.nrows, nrhs), torch.float64)
    B[n:] = 0
    X = torch.zeros_like(B)
    res = [1.0]

    def ir():
        nonlocal X
        for _ in range(5):
            X = step(Ae, single.levels, single.tail, X, B)
            R = sliced_ell_sub_mrhs(Aw, X[:n], B[:n])
            res.append(float((R.norm(dim=0) / B[:n].norm(dim=0)).max()))

    dist_count(torch, launches, "ir_step x5", ir)
    gate(all(b2 < a2 for a2, b2 in zip(res, res[1:])),
         f"IR residual did not fall every step: {res}")
    report["sharded"] = dict(sharded_spmv_err=e_s, halo_spmv_err=e_h,
                             halo=H.halo, ir_residuals=res,
                             launches={k: launches[k] for k in (
                                 "sharded_spmv", "halo_spmv",
                                 "ir_step x5")})
    report["sharded"]["seconds"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    log(f"  (2, 4) mesh: sharded_spmv / halo_spmv (halo {H.halo}) vs K1 "
        f"on A: {e_s:.3e} / {e_h:.3e} (tol 1e-12); IR step x5 residuals "
        f"{['%.3e' % r for r in res]}; launches "
        f"{report['sharded']['launches']}")

    # 4. the ring Schur and dist_schur=1: convdiff2d(128) on the anchors
    Ac = convdiff2d(128)
    base = dict(FIXTURE_OPTS, use_native=0)
    t0 = time.perf_counter()
    Ph = ht.HIF().factorize(Ac, ht.Options(**base), device=dev)
    hsecs = time.perf_counter() - t0
    calls = []
    ring = pschur.schur_spgemm_ring

    def recording(C, L_E, d, U_F, mesh=None, device="cuda"):
        calls.append((C, L_E, d, U_F))
        return ring(C, L_E, d, U_F, mesh=mesh, device=device)

    pschur.schur_spgemm_ring = recording
    try:
        t0 = time.perf_counter()
        Pd = dist_count(torch, launches, "dist_schur factorize",
                        lambda: ht.HIF().factorize(
                            Ac, ht.Options(dist_schur=1, **base),
                            device=dev))
        dsecs = time.perf_counter() - t0
    finally:
        pschur.schur_spgemm_ring = ring
    gate([(p.m, p.n) for p in Pd.precs] == [(p.m, p.n) for p in Ph.precs],
         "dist_schur levels differ from the host Schur's")
    terr = 0.0
    if Ph.precs[-1].dense_matrix is not None:
        dh, dd = Ph.precs[-1].dense_matrix, Pd.precs[-1].dense_matrix
        terr = float(np.abs(dd - dh).max() / np.abs(dh).max())
    bc = rng.standard_normal(Ac.nrows)
    xch = Ph.solve(bc)
    serr = float(np.abs(Pd.solve(bc) - xch).max() / np.abs(xch).max())
    gate(terr <= 1e-12 and serr <= 1e-12, f"dist_schur tail {terr:.3e}, "
         f"solve {serr:.3e}")
    # one K10b launch a ring step: make_mesh's eight ranks on one card are
    # one group, eight steps a level whose tail has rows
    steps = 8 * sum(1 for c in calls if c[1].nrows)
    gate(launches["dist_schur factorize"]["K10b"] == steps > 0,
         f"dist_schur: {launches['dist_schur factorize']['K10b']} K10b "
         f"launches for {steps} ring steps")
    big = max(calls, key=lambda c: c[1].nrows)
    report["dist_schur"] = dict(
        levels=[(p.m, p.n) for p in Pd.precs], host_seconds=hsecs,
        dist_seconds=dsecs, ring_calls=len(calls), tail_err=terr,
        solve_err=serr, launches=launches["dist_schur factorize"])
    report["dist_schur"]["seconds"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    log(f"  convdiff2d(128) dist_schur=1 (anchors): levels "
        f"{report['dist_schur']['levels']}, {len(calls)} ring SpGEMMs, "
        f"{dsecs:.2f} s vs host Schur {hsecs:.2f} s; tail rel err "
        f"{terr:.3e}, solve {serr:.3e} (tol 1e-12); launches "
        f"{launches['dist_schur factorize']}")

    # 5. PartitionedHIF, eight parts of poisson2d(512)
    t0 = time.perf_counter()
    PP = PartitionedHIF().factorize(A, 8, ht.Options(verbose=0))
    psecs = time.perf_counter() - t0
    xr = PP.solve(b)
    rmax = np.abs(xr).max()
    dpp = PP.to_device(device=dev)
    xd = dist_count(torch, launches, "partitioned to_device",
                    lambda: dpp.solve(b))
    e_d = float(np.abs(xd - xr).max() / rmax)
    t0 = time.perf_counter()
    PP.attach_dist_solvers(mesh, chunk=DIST_CHUNK, max_halo_chunks=128)
    asecs = time.perf_counter() - t0
    t0 = time.perf_counter()
    xa = dist_count(torch, launches, "partitioned DistPrec",
                    lambda: PP.local_contrib(b))
    a_ms = (time.perf_counter() - t0) * 1e3
    e_a = float(np.abs(xa - xr).max() / rmax)
    xt = PP.solve(b, trans=True)
    gate(np.array_equal(PP.local_contrib(b, trans=True), xt),
         "the partitioned adjoint left the host path")
    gate(e_d <= 1e-12 and e_a <= 1e-12, f"partitioned device forms vs host "
         f"RAS: {e_d:.3e} / {e_a:.3e}")
    shape = dict(factors=sum(dist_solve_factors(p.M_dist)["factors"]
                             for p in PP.parts if p.M_dist is not None))
    gate(shape["factors"] > 0, "partitioned DistPrec: no distributed factor")
    sweep_gates(launches["partitioned DistPrec"], shape,
                "partitioned DistPrec")
    report["partitioned"] = dict(
        factorize_seconds=psecs, attach_seconds=asecs,
        levels=PP.levels(), err_to_device=e_d, err_dist=e_a,
        dist_apply_ms_host_clock=a_ms,
        launches={k: launches[k] for k in ("partitioned to_device",
                                           "partitioned DistPrec")})
    report["partitioned"]["seconds"] = time.perf_counter() - t_part
    log(f"  PartitionedHIF 8 parts of poisson2d({DIST_NX}): factorize "
        f"{psecs:.2f} s, attach_dist_solvers {asecs:.2f} s; to_device / "
        f"DistPrec-a-part vs host RAS {e_d:.3e} / {e_a:.3e} (tol 1e-12); "
        f"DistPrec apply {a_ms:.1f} ms (host clock); launches "
        f"{report['partitioned']['launches']} [{smi}]")

    log("  seconds by part: " + ", ".join(
        f"{k} {v['seconds']:.1f}" for k, v in report.items()))
    # the kernel rows: K10a on a group of the two-group solve, the sweep in
    # the main path's all_gather form and in the halo form (poisson2d(64)'s
    # first level carried by a halo factor)
    hl = next(i for i, lv in enumerate(dp64_halo.levels)
              if isinstance(lv.L_op, HaloOp))
    for name, dp in dps.items():
        k10a_row(torch, book, rng, dps2[name])
        sweep_row(torch, book, rng, dp, 0, P.precs[0].L_B, "K10a_sweep")
        dph = dp64_halo if name == "float64" else DistPrec.from_host(
            mesh, P64, dtype=np.float32, chunk=64)
        sweep_row(torch, book, rng, dph, hl, P64.precs[hl].L_B,
                  "K10a_sweep_halo")
        k10b_row(torch, book, big, mesh, dp.dtype)
        # the same seeded operands in both dtypes
        report.setdefault("k10b_edges", []).extend(k10b_tiers(
            torch, book, np.random.default_rng(k10b_seed), dp.dtype))
    return report, launches, book.rows


# ---------------------------------------------------------------------------
# the entry points, the DistPrec path matrix, the device demos, poisson3d

def entry_phase(torch, smi):
    """``hifir_tpu_torch.entry`` on the card: ``entry()``'s ``fn(*args)``
    against the host f64 solve of the same factorization (1e-4 of max|X|,
    float32) with K1 and K2 launched as the pack's forms say, then
    ``dryrun_multichip(8)`` with its asserts as gates, one sweep launch a
    factor application of its DistPrec solve and no plain-version call, and
    that solve's time (CUDA events).  Returns the report and the launches
    of each part."""
    from hifir_tpu_torch.entry import _small_prec, dryrun_multichip, entry

    launches, report = {}, {}
    fn, args = entry()
    X = count_launches(torch, launches, "entry", lambda: fn(*args))
    gate(bool(torch.isfinite(X).all()), "entry: non-finite")
    _, M = _small_prec(nx=12)
    n = M.precs[0].n
    gate(tuple(X.shape) == (n, 8) and X.dtype == torch.float32,
         f"entry: {tuple(X.shape)} {X.dtype}")
    ref = M.solve_mrhs(np.ones((n, 8)))
    d = float(np.abs(X.double().cpu().numpy() - ref).max()
              / np.abs(ref).max())
    want = want_launches([(v.L, v.U, v.E, v.F) for v in args[0]])
    ms = timed(torch, lambda: fn(*args), 20)
    report["entry"] = dict(n=n, levels=[(p.m, p.n) for p in M.precs],
                           rel_diff=d, tol=1e-4, ms=ms,
                           launches=launches["entry"], want=want)
    log(f"  entry(): convdiff2d(12), levels {report['entry']['levels']}, "
        f"f32 chunk=1024, B = ones(({n}, 8)): rel diff vs host f64 {d:.3e} "
        f"(tol 1e-4); {ms:.4f} ms a call (CUDA events); launches "
        f"{launches['entry']}, by the pack's forms {want} [{smi}]")
    gate(d <= 1e-4, f"entry: {d:.3e} > 1e-4")
    for k, v in want.items():
        gate(launches["entry"][k] == v, f"entry: {launches['entry'][k]} {k} "
             f"launches, expected {v}")
    gate(launches["entry"]["K1"] > 0, "entry: no K1 launch")

    t0 = time.perf_counter()
    rep = dist_count(torch, launches, "dryrun_multichip(8)",
                     lambda: dryrun_multichip(8))
    secs = time.perf_counter() - t0
    dp = rep["dist"]
    shape = dist_solve_factors(dp)
    per = launches["dryrun_multichip(8)"]
    ones = np.ones(dp.levels[0].n)
    solve = dist_count(torch, launches, "dryrun DistPrec solve",
                       lambda: dp.solve(ones))
    sweep_gates(launches["dryrun DistPrec solve"], shape,
                "dryrun_multichip(8) DistPrec")
    gate(per["sweep"] == launches["dryrun DistPrec solve"]["sweep"]
         and per["K1"] > 0, f"dryrun_multichip(8): launches {per}")
    err = float(np.abs(solve.cpu().numpy() - rep["x_host"]).max()
                / np.abs(rep["x_host"]).max())
    ms = timed(torch, lambda: dp.solve(ones), 5)
    report["dryrun"] = dict(
        seconds=secs, ir_residual0=rep["ir_residual0"],
        ir_residual2=rep["ir_residual2"], n_halo=dp.n_halo,
        comm_elems=dp.comm_elems, allgather_elems=dp.allgather_elems,
        **shape, err_vs_host=err, solve_ms=ms, launches=per)
    log(f"  dryrun_multichip(8): {secs:.2f} s (host clock, with the two "
        f"factorizes); IR residual {rep['ir_residual0']:.4g} -> "
        f"{rep['ir_residual2']:.4g}; DistPrec convdiff2d(40) chunk 32: "
        f"{dp.n_halo} halo factors, comm {dp.comm_elems} < allgather "
        f"{dp.allgather_elems}, {shape['chunks_per_solve']} chunks a solve; "
        f"rel err vs host {err:.3e} (tol 1e-8); solve {ms:.4f} ms (CUDA "
        f"events); launches {per} [{smi}]")
    gate(err <= 1e-8, f"dryrun DistPrec solve {err:.3e}")
    return report, launches


PATHS_NX = 64


def paths_phase(torch, rng, smi):
    """The DistPrec path matrix on eight ranks of the card: the symmetric
    (LDL^T, poisson2d(64)), general nonsymmetric and pivoting
    (convdiff2d(64)) factorizations, each in the halo and the all_gather
    form, float64 and float32, against the host solve (1e-12 / 1e-4 of
    max|x|), one sweep launch a factor application and no K10a or plain
    call, with each form's solve time (CUDA events).  Returns the report
    and the launches of each form."""
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.models import problems
    from hifir_tpu_torch.options import PIVOTING_ON
    from hifir_tpu_torch.parallel import DistPrec, make_mesh

    # path -> (operator, the options beyond RED_OPTS): the factorizations
    # tests/test_torch_parallel_paths.py holds to the JAX DistPrec
    paths = {"symmetric": ("poisson2d", dict(is_symm=1)),
             "nonsymmetric": ("convdiff2d", {}),
             "pivoting": ("convdiff2d", dict(pivot=PIVOTING_ON))}
    mesh = make_mesh(DIST_RANKS)
    launches, report = {}, {}
    for path, (op, extra) in paths.items():
        A = getattr(problems, op)(PATHS_NX)
        t0 = time.perf_counter()
        P = ht.HIF().factorize(A, ht.Options(**dict(RED_OPTS, **extra)))
        secs = time.perf_counter() - t0
        b = rng.standard_normal(A.nrows)
        xh = P.solve(b)
        rep = report[path] = dict(
            operator=f"{op}({PATHS_NX})", factorize_seconds=secs,
            levels=[(p.m, p.n) for p in P.precs],
            tail=P.precs[-1].dense_solver.kind
            if P.precs[-1].dense_solver is not None else None)
        for form, halo in (("halo", True), ("all_gather", False)):
            for npdt, tol in ((np.float64, 1e-12), (np.float32, 1e-4)):
                dt = np.dtype(npdt).name
                key = f"{path} {form} {dt}"
                dp = DistPrec.from_host(mesh, P, dtype=npdt, chunk=64,
                                        halo=halo)
                shape = dist_solve_factors(dp)
                x = dist_count(torch, launches, key,
                               lambda: dp.solve(b)).double().cpu().numpy()
                per = launches[key]
                err = float(np.abs(x - xh).max() / np.abs(xh).max())
                ms = timed(torch, lambda: dp.solve(b), 5)
                rep[f"{form} {dt}"] = dict(
                    err=err, tol=tol, ms=ms, n_halo=dp.n_halo,
                    comm_elems=dp.comm_elems,
                    allgather_elems=dp.allgather_elems, **shape,
                    launches=per)
                log(f"  {path:12s} {form:10s} {dt}: levels {rep['levels']} "
                    f"tail {rep['tail']}; rel err vs host {err:.3e} (tol "
                    f"{tol:.0e}); {dp.n_halo} halo factors, "
                    f"{shape['chunks_per_solve']} chunks a solve; solve "
                    f"{ms:.4f} ms (CUDA events); launches {per} [{smi}]")
                gate(err <= tol, f"DistPrec {key}: {err:.3e} > {tol}")
                sweep_gates(per, shape, f"DistPrec {key}")
                gate(per["sweep"] > 0, f"DistPrec {key}: no sweep launch")
                if halo:
                    gate(dp.n_halo > 0 and dp.comm_elems
                         < dp.allgather_elems, f"DistPrec {key}: halo "
                         f"{dp.n_halo}, comm {dp.comm_elems} / "
                         f"{dp.allgather_elems}")
    return report, launches


def demos_phase(torch, smi):
    """The two device demos of ``hifir_tpu_torch.examples`` run in-process
    on the card, each counted: ``demo_device_batch`` (poisson2d(128), a
    float32 64-RHS M-solve, fgmres_hifir to rtol 1e-8: flag 0, residual
    within 1.01 rtol, the solve within 1e-4 of the host's on 8 columns) and
    ``demo_pseudoinverse_device`` (the 40x40 rank-deficient system: the
    null space found, the relative residual and the distance to pinv within
    the module's bounds, and one float32 filtered apply within 1e-4 of the
    host's filtered solve, since 50 steps of IR with float64 residuals
    converge even from a poor apply).  Returns the report and the launches
    of each."""
    from hifir_tpu_torch.examples import (demo_device_batch,
                                          demo_pseudoinverse_device)

    launches, report = {}, {}
    t0 = time.perf_counter()
    r = count_launches(torch, launches, "demo_device_batch",
                       lambda: demo_device_batch.main([]))
    secs = time.perf_counter() - t0
    cols = np.linspace(0, r["X"].shape[1] - 1, 8).astype(int)
    Bh = r["B"].double().cpu().numpy()
    ref = np.stack([r["M"].solve(Bh[:, c]) for c in cols], axis=1)
    d = float(np.abs(r["X"][:, torch.as_tensor(cols, device=r["X"].device)]
                     .double().cpu().numpy() - ref).max() / np.abs(ref).max())
    per = launches["demo_device_batch"]
    report["demo_device_batch"] = dict(
        seconds=secs, solve_ms_host_clock=r["solve_ms"], flag=r["flag"],
        iters=r["iters"], res=r["res"], rel_diff=d, launches=per)
    log(f"  demo_device_batch: {secs:.2f} s in all (host clock); 64-RHS f32 "
        f"solve {r['solve_ms']:.2f} ms (host clock around a sync), rel diff "
        f"vs host f64 {d:.3e} on columns {cols.tolist()} (tol 1e-4); FGMRES "
        f"flag {r['flag']}, {r['iters']} iterations, res {r['res']:.3e}; "
        f"launches {per} [{smi}]")
    gate(r["flag"] == 0 and r["res"] <= 1.01e-8,
         f"demo_device_batch: flag {r['flag']}, res {r['res']:.3e}")
    gate(d <= 1e-4, f"demo_device_batch solve: {d:.3e} > 1e-4")
    gate(per["K1"] > 0, f"demo_device_batch: launches {per}")

    t0 = time.perf_counter()
    r = count_launches(torch, launches, "demo_pseudoinverse_device",
                       lambda: demo_pseudoinverse_device.main([]))
    secs = time.perf_counter() - t0
    M, dp = r["M"], r["dp"]
    M.nsp = dp.nsp
    xh = M.solve(r["b"])
    xd = dp.solve(torch.as_tensor(r["b"], dtype=torch.float64,
                                  device=dp.device)).double().cpu().numpy()
    da = float(np.abs(xd - xh).max() / np.abs(xh).max())
    report["demo_pseudoinverse_device"] = dict(
        seconds=secs, rank=r["rank"], tail_n=r["tail_n"],
        rel_res=r["rel_res"], pinv_err=r["pinv_err"], apply_rel_diff=da,
        res_bound=demo_pseudoinverse_device.RES_BOUND,
        pinv_bound=demo_pseudoinverse_device.PINV_BOUND,
        launches=launches["demo_pseudoinverse_device"])
    log(f"  demo_pseudoinverse_device: {secs:.2f} s; tail rank {r['rank']} "
        f"of {r['tail_n']}; rel.res {r['rel_res']:.3e} (bound "
        f"{demo_pseudoinverse_device.RES_BOUND:.0e}), vs pinv "
        f"{r['pinv_err']:.3e} (bound "
        f"{demo_pseudoinverse_device.PINV_BOUND:.0e}); f32 apply vs host "
        f"{da:.3e} (tol 1e-4); launches "
        f"{launches['demo_pseudoinverse_device']} [{smi}]")
    gate(r["rank"] < r["tail_n"], "pseudoinverse: the null space was not "
         "found")
    gate(r["rel_res"] <= demo_pseudoinverse_device.RES_BOUND
         and r["pinv_err"] <= demo_pseudoinverse_device.PINV_BOUND,
         f"pseudoinverse: {r['rel_res']:.3e} / {r['pinv_err']:.3e}")
    gate(da <= 1e-4, f"pseudoinverse apply: {da:.3e} > 1e-4")
    return report, launches


P3_NX = 64
P3_NRHS = 128


def poisson3d_phase(torch, rng, smi):
    """poisson3d(64) (n = 262144) on the card: :func:`robust_cell` at 128
    RHS with the f64 adjoint.  Returns the report, the launches of each
    part and what each must be."""
    from hifir_tpu_torch.models.problems import poisson3d

    report, launches, want, *_ = robust_cell(
        torch, rng, smi, poisson3d(P3_NX), f"poisson3d({P3_NX})", "3D",
        P3_NRHS, adjoint=True)
    check_launches(launches, want)
    return report, launches, want

_SOURCES = {
    "K7": ("K7_bsr", "cuda", "hifir_tpu_torch/csrc/kernels.cu",
           "hifir_tpu/ops/pallas_spmv.py:133"),
    "K1": ("K1_sell", "cuda", "hifir_tpu_torch/csrc/kernels.cu",
           "hifir_tpu/ops/spmv.py:167"),
    "K2": ("K2_trsv", "cuda", "hifir_tpu_torch/csrc/kernels.cu",
           "hifir_tpu/ops/trsv.py:544"),
}
# the distribution phase's kernels: (name, route, source, replaces, the run
# whose launches stand for the kernel, its row).  The sweep carries the
# DistPrec solve on one group; K10a a chunk carries the same solve on two
# groups, and its row is taken from that run's operator.
_DIST_SOURCES = {
    "K10a": ("K10a_chunk", "cuda", "hifir_tpu_torch/csrc/kernels.cu",
             "hifir_tpu/parallel/prec_sharded.py:92",
             "distprec float64 solve two groups", "K10a_chunk"),
    "sweep": ("K10a_sweep", "cuda", "hifir_tpu_torch/csrc/kernels.cu",
              "hifir_tpu/parallel/prec_sharded.py:77",
              "distprec float64 solve", "K10a_sweep"),
    "K10b": ("K10b_schur", "cuda", "hifir_tpu_torch/csrc/kernels.cu",
             "hifir_tpu/parallel/schur.py:96", "dist_schur factorize",
             "K10b_schur"),
}
# the kernel-phase row that stands for each kernel in the summary line: the
# shape, dtype and form it runs at on the main path (HIFIR's A-product is
# f64 at 128 RHS; the M-solve kernels are timed in f32, the bench dtype)
_MAIN_ROW = {"K7": ("K7_bsr", "float64", (f"nrhs={NRHS} ",)),
             "K1": ("K1_sell_E", "float32",
                    (f"nrhs={NRHS} ", "form=in-place")),
             "K2": ("K2_trsv_L", "float32", ("level=0 ", f"nrhs={NRHS} "))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="directory for the full JSON report and nvcc log")
    ap.add_argument("--profile-probe", type=float, default=0.0,
                    metavar="SECONDS",
                    help="only measure, for SECONDS, how often a profiled "
                    "window loses device records with and without its pads")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import hifir_tpu_torch as ht
    from hifir_tpu_torch.kernels.build import (load_kernels, nvcc_path,
                                               nvcc_version)
    from hifir_tpu_torch.native.build import load_native
    from hifir_tpu_torch.models.problems import (convdiff2d, poisson2d,
                                                 shift_diagonal)

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
    # nvcc for the kernels and g++ for the native host library, together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        fk, fn = ex.submit(load_kernels), ex.submit(load_native)
        kl, nl = fk.result(), fn.result()
    log(f"  {kl.path.name}: nvcc {kl.build_seconds:.2f} s")
    native_build = dict(name=nl.path.name, seconds=nl.build_seconds,
                        nvcc_seconds=kl.build_seconds,
                        both_seconds=time.perf_counter() - t0)
    log(f"  native host library {nl.path.name}: g++ {nl.build_seconds:.2f} s "
        f"({cpu_model()}); both built in {time.perf_counter() - t0:.2f} s "
        f"[{smi}]")
    if args.profile_probe:
        log(f"== profiler probe, {args.profile_probe:.0f} s")
        print(json.dumps({"profile_probe": profile_probe(
            torch, args.profile_probe, args.out)}))
        print(smi)
        return 0

    rng = np.random.default_rng(args.seed)
    M = ht.load_prec(FIXTURE)
    A = poisson2d(128)
    nnz = M.nnz()
    log(f"  frozen fixture: n={M.precs[0].n} levels={len(M.precs)} "
        f"nnz(M)={nnz}")
    Mc = ht.load_prec(CONVDIFF)
    Ac = convdiff2d(128)
    log(f"  nonsymmetric fixture: n={Mc.precs[0].n} levels "
        f"{[(p.m, p.n) for p in Mc.precs]} tail "
        f"{Mc.precs[-1].dense_solver.kind} rank "
        f"{Mc.precs[-1].dense_solver.rank} nnz(M)={Mc.nnz()}")
    T = Timer(torch)

    log("== kernel phases (kernel vs plain version on the card)")
    rows, sweeps = kernel_phases(torch, T, M, Mc, rng)

    log("== main path: frozen-operator M-solve and HIFIR (BSR A)")
    launches, per_solve, packs, Bd, Ab, ir_res = main_path(torch, M, A, rng)
    log(f"  launches on the main path: {launches}")
    for k, c in launches.items():
        gate(c > 0, f"kernel {k} was not launched on the main path")

    log(f"== timing: {CHAIN} back-to-back M-solves, {NRHS} RHS")
    timing = time_main_path(torch, packs, Bd, Ab, nnz)

    log("== where the time goes (torch.profiler)")
    prof = profile_phase(torch, packs, Bd, Ab, timing)

    log("== surface: adjoint M-solve, rank, nsp, products, GMRES "
        "(nonsymmetric fixture, A = convdiff2d(128))")
    # its own generator, so that its inputs do not move with the rows above
    surface, spacks, slaunches, swant, sops, sB = surface_phase(
        torch, Mc, Ac, np.random.default_rng(args.seed + 1))
    stotal = check_surface_launches(slaunches, swant)
    log(f"  launches on the surface path: {stotal}")
    log("== surface timing")
    stiming, sprof = time_surface(torch, spacks, sops, Mc, sB)

    log("== complex: c64 and c128 K1/K2 rows, solves, rank, products, GMRES "
        "(complex fixture, A = shift_diagonal(convdiff2d(128)))")
    Mz = ht.load_prec(CONVDIFF_C)
    Az = shift_diagonal(convdiff2d(128))
    log(f"  complex fixture: levels {[(p.m, p.n) for p in Mz.precs]} tail "
        f"{Mz.precs[-1].dense_solver.kind} rank "
        f"{Mz.precs[-1].dense_solver.rank} nnz(M)={Mz.nnz()} "
        f"dtype {Mz.precs[0].d.dtype}")
    # its own generator, so that its inputs do not move with the rows above
    (cplx, crows, csweeps, cpacks, claunches, cwant, cplain,
     cBd) = complex_phase(torch, T, Mz, Az,
                          np.random.default_rng(args.seed + 2))
    ctotal = check_complex_launches(claunches, cwant, cplain)
    log(f"  launches on the complex path by dtype: {ctotal}")
    log("== complex timing")
    ctiming, cprof = time_complex(torch, cpacks, cBd)

    log("== factorize: the port's own factorize, convdiff2d(128) against the "
        "fixture, poisson2d(256) to the M-solve and HIFIR on the card")
    # its own generator, so that its inputs do not move with the rows above
    t_phase = time.perf_counter()
    frng = np.random.default_rng(args.seed + 3)
    freport, flaunches, fwant, fpacks, fBd, fAb = factorize_phase(torch,
                                                                 frng)
    ftotal = {k: sum(c[k] for c in flaunches.values())
              for k in ("K7", "K1", "K2")}
    log(f"  launches on the factorize path: {ftotal}")
    for k, c in ftotal.items():
        gate(c > 0, f"kernel {k} was not launched on the factorize path")
    log("== factorize timing")
    ftiming, fprof = time_factorize(torch, fpacks, fBd, fAb)
    log("== K8: device QRCP of the dense tail")
    k8rows, k8report, k8launches = k8_phase(torch, T, frng, smi)
    freport["seconds_factorize_timing_k8"] = time.perf_counter() - t_phase
    log(f"  factorize, its timing and K8: "
        f"{freport['seconds_factorize_timing_k8']:.1f} s")

    log(f"== 1M: poisson2d({MILLION_NX}) from the matrix, native factorize, "
        f"M-solve at {MILLION_NRHS} and 1 RHS, GMRES and HIFIR on the card")
    # its own generator, so that its inputs do not move with the rows above
    t_phase = time.perf_counter()
    mreport, mlaunches, mwant = million_phase(
        torch, np.random.default_rng(args.seed + 4), smi)
    mtotal = {k: sum(c[k] for c in mlaunches.values())
              for k in ("K7", "K1", "K2")}
    mreport["seconds"] = time.perf_counter() - t_phase
    log(f"  launches on the 1M path: {mtotal}; phase "
        f"{mreport['seconds']:.1f} s")
    for k in ("K1", "K2"):
        gate(mtotal[k] > 0, f"kernel {k} was not launched on the 1M path")

    log("== saddle point: saddle_point_stokes(64), mixed-precision IR "
        "(bench.py's correctness leg)")
    sreport_ir, sir_launches, _ = saddle_phase(
        torch, np.random.default_rng(args.seed + 5), smi)
    sir_total = sir_launches["saddle IR"]
    # its levels are all within the blocked-inverse range: no K2 there
    gate(sir_total["K1"] > 0, "kernel K1 was not launched on the "
         "saddle-point path")

    log("== distribution: eight ranks on one card (hifir_tpu_torch."
        "parallel)")
    # its own generator, so that its inputs do not move with the rows above
    t_phase = time.perf_counter()
    dreport, dlaunches, drows = dist_phase(
        torch, T, np.random.default_rng(args.seed + 6), smi,
        k10b_seed=args.seed + 7)
    dreport["seconds"] = time.perf_counter() - t_phase
    log(f"  distribution phase {dreport['seconds']:.1f} s [{smi}]")

    log("== entry points: entry() and dryrun_multichip(8) on the card "
        "(hifir_tpu_torch.entry)")
    t_phase = time.perf_counter()
    ereport, elaunches = entry_phase(torch, smi)
    ereport["seconds"] = time.perf_counter() - t_phase
    etotal = {k: sum(c.get(k, 0) for c in elaunches.values())
              for k in ("K7", "K1", "K2", "K10a", "sweep", "K10b")}
    log(f"  launches on the entry path: {etotal}; phase "
        f"{ereport['seconds']:.1f} s")

    log("== DistPrec path matrix: symmetric, nonsymmetric and pivoting "
        "factorizations, halo and all_gather forms, eight ranks")
    # its own generator, so that its inputs do not move with the rows above
    t_phase = time.perf_counter()
    preport, plaunches = paths_phase(
        torch, np.random.default_rng(args.seed + 8), smi)
    preport["seconds"] = time.perf_counter() - t_phase
    ptotal = {k: sum(c[k] for c in plaunches.values())
              for k in ("K7", "K1", "K2", "K10a", "sweep", "K10b")}
    log(f"  launches on the path matrix: {ptotal}; phase "
        f"{preport['seconds']:.1f} s")
    for k in ("K1", "sweep"):
        gate(ptotal[k] > 0, f"kernel {k} was not launched on the path "
             f"matrix")

    log("== device demos: demo_device_batch and demo_pseudoinverse_device "
        "(hifir_tpu_torch.examples)")
    t_phase = time.perf_counter()
    demreport, demlaunches = demos_phase(torch, smi)
    demreport["seconds"] = time.perf_counter() - t_phase
    demtotal = {k: sum(c[k] for c in demlaunches.values())
                for k in ("K7", "K1", "K2")}
    log(f"  launches on the demos: {demtotal}; phase "
        f"{demreport['seconds']:.1f} s")

    log(f"== 3D: poisson3d({P3_NX}) from the matrix, native factorize, "
        f"M-solve at {P3_NRHS} and 1 RHS, adjoint, GMRES on the card")
    # its own generator, so that its inputs do not move with the rows above
    t_phase = time.perf_counter()
    p3report, p3launches, p3want = poisson3d_phase(
        torch, np.random.default_rng(args.seed + 9), smi)
    p3report["seconds"] = time.perf_counter() - t_phase
    p3total = {k: sum(c[k] for c in p3launches.values())
               for k in ("K7", "K1", "K2")}
    log(f"  launches on the 3D path: {p3total}; phase "
        f"{p3report['seconds']:.1f} s [{smi}]")
    for k in ("K1", "K2"):
        gate(p3total[k] > 0, f"kernel {k} was not launched on the 3D path")

    offs = [w["offset_ms"] for w in PROFILE_WINDOWS
            if w["offset_ms"] is not None]
    log(f"== profiler: {len(PROFILE_WINDOWS)} windows, "
        f"{sum(w['lost'] for w in PROFILE_WINDOWS)} lost records and were "
        f"taken again; clock offsets {min(offs, default=0):.4f} to "
        f"{max(offs, default=0):.4f} ms (pad {PROFILE_PAD_S * 1e3:.0f} ms)")

    kernels = []
    for k, (name, route, src, repl) in _SOURCES.items():
        rname, rdt, rshape = _MAIN_ROW[k]
        row = next(r for r in rows if r["name"] == rname
                   and r["dtype"] == rdt
                   and all(x in r["shape"] for x in rshape))
        kernels.append(dict(
            name=name, route=route, source=src, replaces=repl,
            launches=launches[k], launches_surface=stotal[k],
            launches_factorize=ftotal[k], launches_1m=mtotal[k],
            launches_saddle=sir_total[k], launches_entry=etotal[k],
            launches_paths=ptotal[k], launches_demos=demtotal[k],
            launches_3d=p3total[k],
            max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], dtype=rdt, shape=row["shape"]))
    for k, (name, route, src, repl) in _SOURCES.items():
        if k == "K7":
            continue    # real only
        rname, _, rshape = _MAIN_ROW[k]
        for dt in CPLX:
            row = next(r for r in crows if r["name"] == rname
                       and r["dtype"] == dt
                       and all(x in r["shape"] for x in rshape))
            kernels.append(dict(
                name=f"{name}_{'c64' if dt == 'complex64' else 'c128'}",
                route=route, source=src, replaces=repl,
                launches=ctotal[dt][k], max_abs_err=row["max_abs_err"],
                ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"], dtype=dt, shape=row["shape"]))

    for k, (name, route, src, repl, run, rname) in _DIST_SOURCES.items():
        row = next(r for r in drows if r["name"] == rname
                   and r["dtype"] == "float64")
        kernels.append(dict(
            name=name, route=route, source=src, replaces=repl,
            launches=dlaunches[run][k], launches_entry=etotal[k],
            launches_paths=ptotal[k], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], library_note=row["library_note"],
            dtype=row["dtype"], shape=row["shape"]))
        gate(dlaunches[run][k] > 0, f"kernel {k} was not launched on the "
             f"distribution path ({run})")

    # K8's rows at the K8 path's shapes (the fixtures' tails in f64), with
    # the launches of that path
    for row in k8rows:
        if row["dtype"] == "float64" and "random" not in row["name"]:
            kernels.append(dict(row, launches=k8launches))

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(nvidia_smi=smi, native_build=native_build,
                           kernel_rows=rows,
                           sweeps=sweeps,
                           ptxas=ptxas_report(kl.ptxas_log),
                           main_path_launches=launches,
                           launches_per_solve=per_solve, timing=timing,
                           profile=prof,
                           hifir_rel_residual=list(map(float, ir_res)),
                           surface=surface, surface_launches=slaunches,
                           surface_launches_total=stotal,
                           surface_timing=stiming, surface_profile=sprof,
                           complex=cplx, complex_kernel_rows=crows,
                           complex_sweeps=csweeps,
                           complex_launches=claunches,
                           complex_plain_calls=cplain,
                           complex_launches_by_dtype=ctotal,
                           complex_timing=ctiming, complex_profile=cprof,
                           factorize=freport, factorize_launches=flaunches,
                           factorize_timing=ftiming,
                           factorize_profile=fprof, k8=k8rows,
                           k8_report=k8report, k8_launches=k8launches,
                           million=mreport,
                           million_launches=mlaunches,
                           million_want=mwant, saddle=sreport_ir,
                           saddle_launches=sir_launches,
                           distribution=dreport,
                           distribution_launches=dlaunches,
                           distribution_kernel_rows=drows,
                           entry=ereport, entry_launches=elaunches,
                           paths=preport, paths_launches=plaunches,
                           demos=demreport, demos_launches=demlaunches,
                           poisson3d=p3report,
                           poisson3d_launches=p3launches,
                           poisson3d_want=p3want,
                           profile_windows=PROFILE_WINDOWS,
                           seconds=time.perf_counter() - t_start), f,
                      indent=1)
        with open(os.path.join(args.out, "nvcc_ptxas.txt"), "w") as f:
            f.write(kl.ptxas_log)
    log(f"== done in {time.perf_counter() - t_start:.1f} s [{smi}]")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
