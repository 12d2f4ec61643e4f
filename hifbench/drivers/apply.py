"""Traffic kind ``apply``: back-to-back block M-solves ``DevicePrec.
solve_mrhs(B)``, one client (a block Krylov method or a multi-RHS solve that
waits for each result).  B cycles through a ring of distinct seeded blocks
made on the device, so no call reuses the input of the call before it.
Correctness: sampled columns of sampled calls against the reference's
float64 M-solve of the same columns (the factorize is checked by itself
for every kind, :func:`hifbench.compare.factorization`)."""

from __future__ import annotations

import time

import numpy as np
import torch

from hifbench import compare, program, reference
from hifbench.window import p95

KIND = "apply"


class Cell:
    """The program set up for one cell: factorized, packed in the traffic's
    dtype, the ring made from ``seed``, the one shape warmed and captured."""

    def __init__(self, config, traffic, A, device, seed, seconds):
        self.A, self.traffic, self.device = A, traffic, device
        self.P, self.factorize_s, self.levels, self.tail = \
            program.factorize(config, A, device)
        self.dtype = traffic["dtype"]
        self.dp = self.P.to_device(dtype=np.dtype(self.dtype), device=device,
                                   dense_inv=traffic["dense_inv"])
        self.n, self.cols, self.ring = A.shape[0], traffic["columns"], \
            traffic["ring"]
        self.make_inputs(seed)
        for i in range(2):          # an eager warm-up and the capture
            self.dp.solve_mrhs(self.B[i])
        program.sync(torch, device)
        t0 = time.perf_counter()
        for i in range(2):
            self.dp.solve_mrhs(self.B[i])
        program.sync(torch, device)
        self.per_call = (time.perf_counter() - t0) / 2
        self.reset(seed, seconds)

    def reset(self, seed, seconds) -> None:
        """A window's inputs from ``seed`` and the calls whose answers are
        checked: drawn from the seed among those the window will surely
        complete (from the warm calls' time), and the last call; from each,
        one column of each half of the block."""
        self.make_inputs(seed)
        rng = np.random.default_rng([seed, 1])
        est = max(1, int(0.8 * seconds / self.per_call))
        calls = rng.choice(est, size=min(self.traffic["check_calls"], est),
                           replace=False)
        half = self.cols // 2 or 1
        self.want = {int(c): sorted({int(rng.integers(0, half)),
                                     int(rng.integers(half, self.cols)
                                         if self.cols > 1 else 0)})
                     for c in calls}
        self.last_cols = self.want[int(calls[0])]
        self.kept, self.last = {}, None

    def make_inputs(self, seed) -> None:
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        self.B = torch.randn((self.ring, self.n, self.cols), generator=g,
                             dtype=getattr(torch, self.dtype),
                             device=self.device)

    def request(self, i, spans):
        with spans("hifbench.apply.call"):
            X = self.dp.solve_mrhs(self.B[i % self.ring])
            s = X.sum()
            program.sync(torch, self.device)
        if i in self.want:
            self.kept[i] = X
        self.last = (i, X)
        return s

    def counts(self, win) -> tuple:
        """``(attempted, failed)``: a call fails where its X is not finite."""
        sums = torch.stack(win.results)
        return win.count, int((~torch.isfinite(sums)).sum())

    def end_to_end(self, win) -> dict:
        return {"rhs_per_s": win.count * self.cols / win.seconds,
                "apply_p95_ms": p95(win.latencies) * 1e3}

    def layer_context(self, win) -> dict:
        return dict(kind=KIND, solves=win.count, nrhs=self.cols,
                    dtype=self.dtype, es=np.dtype(self.dtype).itemsize)

    def sample(self, win) -> list:
        """The checked answers as host arrays: (B columns, X columns)."""
        i, X = self.last
        kept = dict(self.kept)
        kept.setdefault(i, X)
        want = dict(self.want)
        want.setdefault(i, self.last_cols)
        items = []
        for c, X in sorted(kept.items()):
            cols = want[c]
            items.append((program.as_host(self.B[c % self.ring][:, cols]),
                          program.as_host(X[:, cols])))
        return items

    def free(self) -> None:
        del self.dp, self.B, self.kept, self.last
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()


def control(items, levels, tail, A, traffic) -> list:
    """The control in the program's place: the reference in TF32 (the
    configuration's precision is float32 with TF32 off)."""
    P = reference.Prec(levels, tail, "tf32")
    return [(B, reference.msolve(P, B).astype(np.float64)) for B, _ in items]


def judge(items, P, A, traffic) -> dict:
    """``x_gap`` of the checked columns against ``P``, the reference's
    float64 preparation of the host factorization."""
    return {"x_gap": max(compare.gap(X, reference.msolve(P, B))
                         for B, X in items)}
