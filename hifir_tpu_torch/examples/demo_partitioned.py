"""Partitioned (domain-decomposed) HIF factorization demo.

The port of ``examples/demo_partitioned.py``: bands a 2-D Poisson system,
factorizes overlapped diagonal blocks independently (concurrently across
threads), packs every part onto the device and solves with GMRES(30)
preconditioned by the restricted-additive-Schwarz apply (device local
solves) + piecewise-constant coarse correction, for 1, 4 and 8 parts.

    python -m hifir_tpu_torch.examples.demo_partitioned [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

OPTS = dict(verbose=0, tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3,
            kappa=5, kappa_d=5, dense_thres=500)


def main(argv=None) -> list:
    from hifir_tpu_torch.device import resolve_device
    from hifir_tpu_torch.models.problems import poisson2d
    from hifir_tpu_torch.options import Options
    from hifir_tpu_torch.parallel import PartitionedHIF
    from hifir_tpu_torch.solvers.gmres_np import gmres_hif

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nx", type=int, default=256)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    A = poisson2d(args.nx)
    b = np.ones(A.nrows)
    opts = Options(**OPTS)
    out = []
    for nparts in (1, 4, 8):
        t0 = time.perf_counter()
        P = PartitionedHIF().factorize(A, nparts, opts)
        t_fac = time.perf_counter() - t0
        x, flag, iters = gmres_hif(A, P.to_device(device=dev), b,
                                   restart=30, rtol=1e-6, maxit=500)
        res = float(np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b))
        print(f"nparts={nparts:2d} overlap={P.overlap:4d}: "
              f"factorize {t_fac:.2f}s fill {P.nnz() / A.nnz:.2f}  "
              f"GMRES(30) flag={flag} iters={iters} rel.res={res:.2e}")
        out.append(dict(nparts=nparts, overlap=P.overlap, seconds=t_fac,
                        fill=P.nnz() / A.nnz, flag=flag, iters=iters,
                        rel_res=res))
    return out


if __name__ == "__main__":
    main()
