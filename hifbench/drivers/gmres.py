"""Traffic kind ``gmres``: independent systems one after another,
``gmres_hif(A, DevicePrec, b, restart, rtol)`` from x0 = 0, one client (a
stream of solves, such as time steps).  Every system has a b of its own:
a seeded normal vector drawn on the device as the system starts, from one
generator seeded at the window's start, so that the same seed gives the
same b's and no b is used twice.
Correctness, after the window: the true residual of every system's x
against the configuration's rtol, and, on the system with the most
iterations, x against the reference's float64 GMRES run for the
program's count of steps with the reference's M-solve (which a residual
alone cannot see: an f32 M inside f64 GMRES converges too)."""

from __future__ import annotations

import numpy as np
import torch

from hifbench import compare, program, reference
from hifbench.trace import host_syncs

KIND = "gmres"


class Cell:
    """The program set up for one cell: factorized, packed in the traffic's
    dtype, A as sliced ELL, every segment of a restart cycle captured."""

    def __init__(self, config, traffic, A, device, seed, seconds):
        import hifir_tpu_torch as ht
        from hifir_tpu_torch.ds.csr import CSR
        from hifir_tpu_torch.ops.spmv import sliced_ell_from_csr

        self.ht, self.A, self.traffic, self.device = ht, A, traffic, device
        self.P, self.factorize_s, self.levels, self.tail = \
            program.factorize(config, A, device)
        self.dtype = traffic["dtype"]
        self.dp = self.P.to_device(dtype=np.dtype(self.dtype), device=device,
                                   dense_inv=traffic["dense_inv"])
        self.As = sliced_ell_from_csr(CSR.from_scipy(A),
                                      dtype=np.dtype(self.dtype),
                                      device=device)
        self.n = A.shape[0]
        self.restart, self.rtol = traffic["restart"], traffic["rtol"]
        self.maxit = traffic["maxit"]
        # one whole cycle captures every segment a system can reach, then
        # one system as the window runs them
        self.reset(seed, seconds)
        ht.gmres_hif(self.As, self.dp, self.next_b(), restart=self.restart,
                     rtol=0.0, maxit=self.restart)
        ht.gmres_hif(self.As, self.dp, self.next_b(), restart=self.restart,
                     rtol=self.rtol, maxit=self.maxit)
        program.sync(torch, device)
        self.count_syncs = False
        self.reset(seed, seconds)

    def reset(self, seed, seconds) -> None:
        """A window's generator of b's from ``seed``; the kept b's and
        answers are cleared."""
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.bs, self.xs = [], []

    def next_b(self):
        return torch.randn(self.n, generator=self.gen,
                           dtype=getattr(torch, self.dtype),
                           device=self.device)

    def request(self, i, spans):
        b = self.next_b()

        def solve():
            return self.ht.gmres_hif(self.As, self.dp, b,
                                     restart=self.restart, rtol=self.rtol,
                                     maxit=self.maxit)

        with spans("hifbench.gmres.system"):
            if self.count_syncs:
                (x, flag, it), reads = host_syncs(torch, solve)
            else:
                (x, flag, it), reads = solve(), None
            program.sync(torch, self.device)
        self.bs.append(b)
        self.xs.append(x)
        return flag, it, reads

    def counts(self, win) -> tuple:
        fin = [bool(torch.isfinite(x).all()) for x in self.xs]
        return win.count, sum(not (f == 0 and ok) for (f, _, _), ok
                              in zip(win.results, fin))

    def end_to_end(self, win) -> dict:
        solved = win.count - self.counts(win)[1]
        return {"tts_ms": win.seconds * 1e3 / max(solved, 1)}

    def layer_context(self, win) -> dict:
        return dict(kind=KIND, solves=win.count,
                    iters=[it for _, it, _ in win.results],
                    reads=[r for _, _, r in win.results], nrhs=1,
                    restart=self.restart, nnz_a=int(self.A.nnz),
                    dtype=self.dtype, es=np.dtype(self.dtype).itemsize)

    def sample(self, win) -> list:
        """Every system as host arrays, ``{"b", "x", "steps", "check"}``;
        ``check`` marks the one whose x is held against the reference's:
        the system with the most steps."""
        its = [it for _, it, _ in win.results]
        pick = int(np.argmax(its))
        return [dict(b=program.as_host(self.bs[i]),
                     x=program.as_host(self.xs[i]), steps=its[i],
                     check=i == pick) for i in range(win.count)]

    def free(self) -> None:
        del self.dp, self.As, self.bs, self.xs
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()


def control(items, levels, tail, A, traffic) -> list:
    """The control in the program's place, on the checked systems: the
    reference's GMRES in float32 (the configuration's precision is
    float64), to its own convergence."""
    P = reference.Prec(levels, tail, "float32")
    out = []
    for it in items:
        if it["check"]:
            x, steps, _ = reference.gmres(A, P, it["b"], traffic["restart"],
                                          traffic["rtol"], traffic["maxit"])
            out.append(dict(it, x=x.astype(np.float64), steps=steps))
    return out


def judge(items, P, A, traffic) -> dict:
    """``residual``, the worst true relative residual of every system, and
    ``x_gap`` of the checked systems against ``P``, the reference's
    float64 preparation of the host factorization."""
    res, x_gap = 0.0, 0.0
    for it in items:
        b, x = it["b"], it["x"]
        res = max(res, float(np.linalg.norm(b - A @ x) / np.linalg.norm(b)))
        if it["check"]:
            xr, _, _ = reference.gmres(A, P, b, traffic["restart"],
                                       traffic["rtol"], traffic["maxit"],
                                       steps=it["steps"])
            x_gap = max(x_gap, compare.gap(x, xr))
    return {"residual": res, "x_gap": x_gap}
