#!/usr/bin/env python3
"""Count the 1M pack and check its device solves, timing nothing on the card.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/probe_1m.py

It builds the native host library and the CUDA kernels, factorizes
poisson2d(1024) with ``Options(verbose=0)`` (host clock), solves 64
seeded right-hand sides and one on the host (host clock), packs ``auto``
in float32 and float64 (host clock, bytes by operand, each level's schedule
counts), and checks one device solve at 64 and at 1 RHS of each pack
against the host solve, with the launch counts.  It writes
``chiprun_out/probe_1m.json``.  The counts are what a prediction of the
device times starts from (PERF.md).
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import hifir_tpu_torch as ht  # noqa: E402
from hifir_tpu_torch.kernels.build import load_kernels  # noqa: E402
from hifir_tpu_torch.models.problems import poisson2d  # noqa: E402
from hifir_tpu_torch.native.build import load_native  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_1m: no CUDA device", file=sys.stderr)
        return 2
    out = dict(smi=cs.power_line(), cpu=cs.cpu_model(),
               torch=torch.__version__, cuda=torch.version.cuda)
    out["native_build_s"] = load_native().build_seconds
    out["nvcc_s"] = load_kernels().build_seconds
    A = poisson2d(1024)
    t0 = time.perf_counter()
    P = ht.HIF().factorize(A, ht.Options(verbose=0))
    out["factorize_s"] = time.perf_counter() - t0
    out["levels"] = [(p.m, p.n) for p in P.precs]
    out["nnz_M"] = P.nnz()
    out["fill"] = P.nnz() / A.nnz
    B = np.random.default_rng(4).standard_normal((A.nrows, 64))
    t0 = time.perf_counter()
    ref = P.solve_mrhs(B)
    out["host_mrhs_s"] = time.perf_counter() - t0
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        ref1 = P.solve(B[:, 0])
        ts.append(time.perf_counter() - t0)
    out["host_1rhs_ms"] = [t * 1e3 for t in ts]
    for npdt in (np.float32, np.float64):
        dt = np.dtype(npdt).name
        t0 = time.perf_counter()
        dp = P.to_device(dtype=npdt)
        torch.cuda.synchronize()
        out[f"pack_{dt}_s"] = time.perf_counter() - t0
        out[f"pack_{dt}_bytes"] = cs.pack_bytes(torch, dp)["forward"]
        if dt == "float32":
            out["schedules"] = cs.schedule_counts(dp)
        Bd = torch.as_tensor(B, dtype=getattr(torch, dt), device="cuda")
        cs.reset_counts()
        X = dp.solve_mrhs(Bd)
        torch.cuda.synchronize()
        out[f"launches_{dt}"] = cs.read_counts()
        out[f"rel_{dt}_64"] = float(np.abs(X.double().cpu().numpy() - ref)
                                    .max() / np.abs(ref).max())
        x = dp.solve(Bd[:, 0].contiguous())
        out[f"rel_{dt}_1"] = float(np.abs(x.double().cpu().numpy() - ref1)
                                   .max() / np.abs(ref1).max())
        out[f"want_{dt}"] = cs.want_launches([(v.L, v.U, v.E, v.F)
                                              for v in dp.levels])
        print({k: v for k, v in out.items() if k != "schedules"},
              flush=True)
        del dp, X, x, Bd
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "probe_1m.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
