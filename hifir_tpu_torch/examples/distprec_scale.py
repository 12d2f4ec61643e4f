"""DistPrec at scale on eight ranks of one device (BASELINE config 5 leg).

The port of ``examples/distprec_scale.py``: builds a robust multilevel
factorization of poisson2d(nx), distributes it with
:class:`hifir_tpu_torch.parallel.DistPrec` over eight devices of the JAX
demo's virtual mesh, here eight ranks of the port's mesh on one device,
and records the factorize time, the DistPrec build time, the first and the
steady solve time (CUDA events on a card), the distributed solve against
the host apply (within 1e-12), and the bytes a device (rank) holds (the
sharded factor, the replicated dense tail, the per-level vectors).  The
port has no jit compile: its first solve runs the kernels as every later
one does.

    python -m hifir_tpu_torch.examples.distprec_scale [nx=512] [chunk=4096]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    from hifir_tpu_torch.api import HIF
    from hifir_tpu_torch.device import resolve_device
    from hifir_tpu_torch.models.problems import poisson2d
    from hifir_tpu_torch.options import Options
    from hifir_tpu_torch.parallel import DistPrec, make_mesh

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("nx", nargs="?", type=int, default=512)
    ap.add_argument("chunk", nargs="?", default="4096")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    chunk = args.chunk if args.chunk == "auto" else int(args.chunk)

    A = poisson2d(args.nx)
    n = A.nrows
    D = 8
    print(f"n={n} nnz={A.nnz} chunk={chunk} devices={D} on {dev}")

    t0 = time.perf_counter()
    M = HIF().factorize(A, Options(verbose=0), device=dev)
    t_fact = time.perf_counter() - t0
    print(f"factorize {t_fact:.1f}s fill={M.nnz() / A.nnz:.2f} "
          f"levels={M.levels()}")

    mesh = make_mesh(D, rhs=1, device=dev)
    t0 = time.perf_counter()
    dp = DistPrec.from_host(mesh, M, chunk=chunk)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_build = time.perf_counter() - t0
    nchunks = sum(op.nchunks for lv in dp.levels
                  for op in (lv.L_op, lv.U_op))
    print(f"DistPrec build {t_build:.1f}s halo_factors={dp.n_halo} "
          f"total_chunks={nchunks} comm_elems={dp.comm_elems} "
          f"(tiled-AG scheme would move {dp.allgather_elems})")

    b = np.random.default_rng(0).standard_normal(n)
    t0 = time.perf_counter()
    x = dp.solve(b).cpu().numpy()
    t_first = time.perf_counter() - t0
    reps = 3
    if dev.type == "cuda":
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            dp.solve(b)
        t1.record()
        t1.synchronize()
        t_solve = t0.elapsed_time(t1) / reps
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            dp.solve(b)
        t_solve = (time.perf_counter() - t0) * 1e3 / reps
    print(f"first solve {t_first:.3f}s (no compile step); steady solve "
          f"{t_solve:.2f} ms")

    xh = M.solve(b)
    err = float(np.abs(x - xh).max() / np.abs(xh).max())
    print(f"distributed vs host max rel diff: {err:.2e}")
    assert err < 1e-12, err

    # a device's memory: what scales as n/D against what is replicated
    per = dp.nbytes_per_rank()
    print(f"factor bytes sharded over rows: {per['sharded'] * D / 1e6:.1f} "
          f"MB total ({per['sharded'] / 1e6:.1f} MB/device); vectors "
          f"{per['vectors'] / 1e6:.1f} MB/device; dense tail (replicated): "
          f"{per['replicated'] / 1e6:.1f} MB")
    per_n_repl = per["replicated"] / n
    print(f"replicated bytes per matrix row: {per_n_repl:.1f} "
          f"(x 1e8 rows = {per_n_repl * 1e8 / 1e9:.1f} GB/device at 100M rows)")
    return dict(n=n, factorize_seconds=t_fact, build_seconds=t_build,
                first_solve_seconds=t_first, solve_ms=t_solve, err=err,
                n_halo=dp.n_halo, chunks=nchunks, comm_elems=dp.comm_elems,
                allgather_elems=dp.allgather_elems, bytes_per_rank=per)


if __name__ == "__main__":
    main()
