"""What every driver does with the program: the host factorize (timed: the
``factorize_s`` metric), the host levels for the reference and the
device's synchronisation."""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp

from .hostprec import host_levels

__all__ = ["factorize", "sync", "as_host"]


def factorize(config: dict, A, device):
    """``HIF().factorize`` of the scipy matrix ``A`` with the
    configuration's options; returns the host factorization, its host
    seconds and its levels and dense tail as plain arrays.  A factorize of
    a 16-row operator first loads the native host library (and builds it,
    in a checkout's first run), so that the seconds are the factorize's."""
    import hifir_tpu_torch as ht
    from hifir_tpu_torch.ds.csr import CSR

    opts = ht.Options(**config["options"])
    warm = sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(16, 16),
                    format="csr")
    warm.sort_indices()
    ht.HIF().factorize(CSR.from_scipy(warm), opts, device=device)
    Ah = CSR.from_scipy(A)
    t0 = time.perf_counter()
    P = ht.HIF().factorize(Ah, opts, device=device)
    seconds = time.perf_counter() - t0
    levels, tail = host_levels(P.precs)
    return P, seconds, levels, tail


def sync(torch, device) -> None:
    """Wait for the device's current stream (nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def as_host(t) -> np.ndarray:
    return t.detach().to("cpu", copy=True).double().numpy()
