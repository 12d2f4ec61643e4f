"""Device demo: batched M-solve + device FGMRES on a generated PDE system.

The port of ``examples/demo_tpu_batch.py``: poisson2d(128) factorized on the
host, packed in float32, a 64-RHS M-solve timed with a sync, then
``fgmres_hifir`` with a float64 pack and a sliced-ELL A to rtol 1e-8.

    python -m hifir_tpu_torch.examples.demo_device_batch [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

OPTS = dict(tau_L=1e-2, tau_U=1e-2, alpha_L=3, alpha_U=3, kappa=5, kappa_d=5,
            verbose=0)


def main(argv=None) -> dict:
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.device import resolve_device
    from hifir_tpu_torch.models.problems import poisson2d
    from hifir_tpu_torch.ops.spmv import sliced_ell_from_csr

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nx", type=int, default=128)
    ap.add_argument("--nrhs", type=int, default=64)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    A = poisson2d(args.nx)
    n = A.nrows
    M = ht.HIF().factorize(A, ht.Options(**OPTS), device=dev)
    dp = M.to_device(dtype=np.float32, device=dev)
    B = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (n, args.nrhs)), dtype=torch.float32, device=dev)
    X = dp.solve_mrhs(B)
    sync()
    t0 = time.perf_counter()
    X = dp.solve_mrhs(B)
    sync()
    dt = time.perf_counter() - t0
    print(f"batched M-solve: {dt * 1e3:.1f} ms for {args.nrhs} RHS "
          f"({M.nnz() * args.nrhs / dt / 1e9:.2f} Gnnz/s)")

    Aell = sliced_ell_from_csr(A, device=dev)
    dp64 = M.to_device(device=dev)
    x, flag, iters = ht.fgmres_hifir(Aell, dp64, np.ones(n), restart=30,
                                     rtol=1e-8)
    xn = x.cpu().numpy()
    res = np.linalg.norm(np.ones(n) - A.matvec(xn)) / np.sqrt(n)
    print(f"device FGMRES: flag={flag} iters={iters} res={res:.2e}")
    return dict(n=n, solve_ms=dt * 1e3, B=B, X=X, flag=flag, iters=iters,
                res=float(res), M=M)


if __name__ == "__main__":
    main()
