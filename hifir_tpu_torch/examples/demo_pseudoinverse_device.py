"""Advanced demo: singular-system pseudoinverse fully on the device.

The port of ``examples/demo_pseudoinverse_device.py`` (BASELINE config 4;
ref builder.hpp:410-424 per-solve rank + NspFilter).  A rank-deficient
symmetric 40x40 system (constant null space) is factorized with a
rank-revealing QRCP tail; the device apply (a float32 pack, as the JAX demo
runs on the TPU) then uses the null-space filter while iterative
refinement with float64 residuals drives x to the least-norm solution, and
the runtime rank override truncates the tail per solve.

    python -m hifir_tpu_torch.examples.demo_pseudoinverse_device [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

# what the port's tests (tests/test_torch_graphs_card.py on the card) hold
# the float32-M run to: the relative residual and the distance to pinv(D)
# b.  The residuals are float64, as the printed line says, so 50 steps
# reach ~1e-13 on the CPU;
# the JAX demo, without x64, computes them in float32 and stops near 1e-5.
RES_BOUND = 1e-10
PINV_BOUND = 1e-9


def system(seed: int = 5, n: int = 40):
    """The demo's singular system D (rows and columns sum to zero) and a
    consistent right-hand side b."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n))
    D = B @ B.T
    D -= np.outer(D.sum(1), np.ones(n)) / n   # rows sum to zero
    D -= np.outer(np.ones(n), D.sum(0)) / n   # cols sum to zero
    b = rng.standard_normal(n)
    b -= b.mean()                              # consistent RHS
    return D, b


def main(argv=None) -> dict:
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.device import resolve_device
    from hifir_tpu_torch.ds.csr import csr_from_dense

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    D, b = system()
    n = D.shape[0]
    A = csr_from_dense(D, tol=1e-14)
    M = ht.HIF().factorize(A, ht.Options(verbose=0, dense_thres=50),
                           device=dev)
    dp = M.to_device(dtype=np.float32, device=dev)
    dp.nsp = ht.NspFilter()                    # constant-mode projector
    print(f"tail rank {dp.tail.rank} of {dp.tail.Q.shape[0]} "
          f"(rank-revealing QRCP found the null space)")

    Dd = torch.as_tensor(D, dtype=torch.float64, device=dev)
    bd = torch.as_tensor(b, dtype=torch.float64, device=dev)
    x = torch.zeros(n, dtype=torch.float64, device=dev)
    for _ in range(50):
        r = bd - Dd @ x
        x = x + dp.solve(r).double()          # device apply + nsp filter
    x = x.cpu().numpy()
    x -= x.mean()
    x_star = np.linalg.pinv(D) @ b
    res = float(np.linalg.norm(b - D @ x) / np.linalg.norm(b))
    err = float(np.abs(x - x_star).max() / np.abs(x_star).max())
    print(f"device IR (f32 M, f64 residuals): rel.res={res:.2e}, "
          f"vs pinv={err:.2e} (f32 apply floor ~1e-5)")

    # per-solve rank override (the reference's solve(b, x, trans, rank)):
    # a deliberately truncated rank still contracts, full rank solves exactly
    ranks = {}
    for r in (dp.tail.rank, max(dp.tail.rank - 5, 1)):
        xr = dp.solve(bd, r=r).double().cpu().numpy()
        ranks[r] = float(np.abs(xr).max())
        print(f"rank={r}: |M^+ b|_inf = {ranks[r]:.4g}")
    return dict(rank=int(dp.tail.rank), tail_n=int(dp.tail.Q.shape[0]),
                rel_res=res, pinv_err=err, ranks=ranks, x=x, x_star=x_star,
                M=M, dp=dp, b=b)


if __name__ == "__main__":
    main()
