"""Traffic kind ``hifir``: back-to-back HIFIR calls ``ir_apply(A, DevicePrec,
B, nirs)`` on blocks of right-hand sides, one client (many right-hand sides
of one operator: load cases, or the steps of a time loop).  Every call does
the same work: ``nirs`` M-solves and ``nirs`` - 1 residuals B - A X, with A
as sliced ELL.  B cycles through a ring of distinct seeded blocks made on
the device; where the configuration's generator names the rows of A's null
vector (``null_rows``), each column's mean over them is removed, so that
every column is consistent.  The window, the checked calls and columns and
the end-to-end metrics are the ``apply`` kind's (``drivers/apply.py``).
Correctness: sampled columns of sampled calls against the reference's
float64 HIFIR of the same columns with the same ``nirs``
(:mod:`hifbench.reference_ir`; the factorize is checked by itself for
every kind, :func:`hifbench.compare.factorization`)."""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from hifbench import compare, program, reference, reference_ir, spec

KIND = "hifir"

_apply = spec.load_module(spec.HERE / "drivers" / "apply.py")


class Cell(_apply.Cell):
    """The program set up for one cell: factorized, packed in the traffic's
    dtype, A as sliced ELL, the ring made from ``seed``, the one shape
    warmed and captured."""

    def __init__(self, config, traffic, A, device, seed, seconds):
        import hifir_tpu_torch as ht
        from hifir_tpu_torch.ds.csr import CSR
        from hifir_tpu_torch.ops.spmv import sliced_ell_from_csr

        self.ht, self.A, self.traffic, self.device = ht, A, traffic, device
        self.P, self.factorize_s, self.levels, self.tail = \
            program.factorize(config, A, device)
        self.dtype = traffic["dtype"]
        dt = np.dtype(self.dtype)
        self.dp = self.P.to_device(dtype=dt, device=device,
                                   dense_inv=traffic["dense_inv"])
        self.As = sliced_ell_from_csr(CSR.from_scipy(A), dtype=dt,
                                      device=device)
        self.n, self.cols, self.ring = A.shape[0], traffic["columns"], \
            traffic["ring"]
        self.nirs = traffic["nirs"]
        gen = importlib.import_module(
            f"hifbench.problems.{config['generator']}")
        self.null = gen.null_rows(config) if hasattr(gen, "null_rows") \
            else None
        self.make_inputs(seed)
        for i in range(2):          # an eager warm-up and the capture
            self.call(self.B[i])
        program.sync(torch, device)
        t0 = time.perf_counter()
        for i in range(2):
            self.call(self.B[i])
        program.sync(torch, device)
        self.per_call = (time.perf_counter() - t0) / 2
        self.reset(seed, seconds)

    def call(self, B):
        return self.ht.ir_apply(self.As, self.dp, B, nirs=self.nirs)

    def make_inputs(self, seed) -> None:
        super().make_inputs(seed)
        if self.null is not None:
            P = self.B[:, self.null]
            P -= P.mean(dim=1, keepdim=True)

    def request(self, i, spans):
        with spans("hifbench.hifir.call"):
            X = self.call(self.B[i % self.ring])
            s = X.sum()
            program.sync(torch, self.device)
        if i in self.want:
            self.kept[i] = X
        self.last = (i, X)
        return s

    def layer_context(self, win) -> dict:
        """The apply kind's, with each call's M-solves as ``iters`` (what
        ``k2_roofline`` counts for a kind other than apply), ``nirs`` and
        A's entries."""
        return dict(super().layer_context(win), kind=KIND,
                    iters=[self.nirs] * win.count, nirs=self.nirs,
                    nnz_a=int(self.A.nnz))

    def free(self) -> None:
        del self.As
        super().free()


def control(items, levels, tail, A, traffic) -> list:
    """The control in the program's place: the reference's HIFIR in float32
    (the configuration's precision is float64)."""
    P = reference.Prec(levels, tail, "float32")
    return [(B, reference_ir.hifir(P, A, B, traffic["nirs"])
             .astype(np.float64)) for B, _ in items]


def judge(items, P, A, traffic) -> dict:
    """``x_gap`` of the checked columns against the reference's HIFIR with
    ``P``, the reference's float64 preparation of the host factorization,
    and the traffic's ``nirs``."""
    return {"x_gap": max(compare.gap(X, reference_ir.hifir(P, A, B,
                                                           traffic["nirs"]))
                         for B, X in items)}
