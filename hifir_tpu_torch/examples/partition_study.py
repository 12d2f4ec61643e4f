"""Partition iteration-growth study (BASELINE config 5 leg).

The port of ``examples/partition_study.py``: sweeps partition count x
Schwarz overlap x coarse-space dimension on 2-D Poisson and records
GMRES(30) iterations against the global (1-part) preconditioner.  The
global preconditioner runs on the device (``gmres_hif`` with a sliced-ELL
A), each partitioned one with its parts packed on the device (host GMRES
around the device local solves).

    python -m hifir_tpu_torch.examples.partition_study [nx=256] [quick=0]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

OPTS = dict(verbose=0, tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3,
            kappa=5, kappa_d=5)


def main(argv=None) -> dict:
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.device import resolve_device
    from hifir_tpu_torch.models.problems import poisson2d
    from hifir_tpu_torch.ops.spmv import sliced_ell_from_csr
    from hifir_tpu_torch.parallel import PartitionedHIF
    from hifir_tpu_torch.solvers.gmres_np import gmres_hif as host_gmres

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("nx", nargs="?", type=int, default=256)
    ap.add_argument("quick", nargs="?", default="0")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    nx, quick = args.nx, args.quick == "1"

    A = poisson2d(nx)
    b = np.ones(A.nrows)
    o = ht.Options(**OPTS)
    M = ht.HIF().factorize(A, o, device=dev)
    _, f, it_g = ht.gmres_hif(sliced_ell_from_csr(A, device=dev),
                              M.to_device(device=dev), b, restart=30,
                              rtol=1e-6, maxit=500)
    print(f"nx={nx} n={A.nrows} global: iters={it_g} "
          f"fill={M.nnz() / A.nnz:.2f}", flush=True)

    parts_list = (8, 16) if quick else (4, 8, 16)
    ov_list = (1, 2) if quick else (1, 2, 4)
    q_list = (1, 2) if quick else (1, 2, 3)
    rows = []
    for nparts in parts_list:
        for ov_mult in ov_list:
            # auto overlap = twice the bandwidth; scale it
            overlap = None if ov_mult == 1 else ov_mult * (nx + 1)
            for q in q_list:
                t0 = time.perf_counter()
                P = PartitionedHIF().factorize(A, nparts, o, overlap=overlap,
                                               coarse_dim=q)
                tf = time.perf_counter() - t0
                x, flag, it = host_gmres(A, P.to_device(device=dev), b,
                                         restart=30, rtol=1e-6, maxit=500)
                res = float(np.linalg.norm(b - A.matvec(x))
                            / np.linalg.norm(b))
                print(f"parts={nparts:3d} overlap={P.overlap:5d} q={q} : "
                      f"iters={it:4d} (x{it / it_g:.2f} global) flag={flag} "
                      f"fact {tf:.1f}s", flush=True)
                rows.append(dict(parts=nparts, overlap=P.overlap, q=q,
                                 iters=it, flag=flag, rel_res=res,
                                 seconds=tf))
    return dict(global_iters=it_g, global_flag=f, rows=rows)


if __name__ == "__main__":
    main()
