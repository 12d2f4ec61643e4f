#!/usr/bin/env python3
"""K10b's warp tier (``schur_warp_kernel``) taken apart on the card.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/probe_k10b.py [--out DIR]

It builds ``csrc/kernels.cu`` and four variants of it, made from the source
by text substitution in the warp kernel alone, each nvcc in parallel into
``build/hifir_tpu_torch/``: ``nosort`` drops the sort, ``loads_stores``
also drops the run sums (each candidate stored where it was loaded),
``sort_noloads`` sorts made-up keys without the gathers, ``stores`` keeps
only the stores.  On a seeded row set shaped as convdiff2d(128)'s level 0
(8 ranks x 511 rows, KL = KU = 15, W = 225, panels of 511 columns), it
first holds the real kernel against the plain version (columns exactly,
values 1e-12 / 1e-5), then times every variant in f64 and f32 by CUDA
events, each launch after the Timer's L2 flush (``chip_smoke.Timer``),
beside a one-element fill (the timer's floor).  The differences say where
the kernel's time goes; ``--out DIR`` writes ``DIR/probe_k10b.json``.
"""

import argparse
import concurrent.futures
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from hifir_tpu_torch.kernels import build  # noqa: E402
from hifir_tpu_torch.parallel import schur  # noqa: E402

# (ranks, tail rows nm, U_F rows m, panel width cb, KL, KU, live share)
SHAPE = (8, 4088, 13883, 511, 15, 15, 0.6)

SORT = "  schur_warp_sort<V>(key, lane);\n"
RUNS = """  schur_runs<T, V, false>(key, val, INT_MIN, T(0), INT_MAX, lane, 32, 0, a.W,
                          a.cb, sk, sv, nullptr, nullptr,
                          a.out_c + r * a.W, a.out_v + r * a.W);
}"""
DIRECT = """#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int w = v * 32 + lane;
    if (w < a.W) {
      a.out_c[r * a.W + w] = key[v];
      a.out_v[r * a.W + w] = val[v];
    }
  }
}"""
LOAD = "    schur_candidate(a, r, w, c, x);\n"
NOLOAD = "    c = (w * 7) % 50;\n    x = T(w);\n"


def variants(src: str) -> dict:
    for s in (SORT, RUNS, LOAD):
        if src.count(s) != 1:
            raise RuntimeError(f"probe_k10b: the warp kernel changed; "
                               f"{s.strip()[:40]!r} not found once")
    return {"full": src,
            "nosort": src.replace(SORT, ""),
            "loads_stores": src.replace(SORT, "").replace(RUNS, DIRECT),
            "sort_noloads": src.replace(LOAD, NOLOAD).replace(RUNS, DIRECT),
            "stores": src.replace(SORT, "").replace(RUNS, DIRECT)
            .replace(LOAD, NOLOAD)}


def build_all(texts: dict) -> dict:
    """Each variant's library (hash-named as ``load_kernels`` names them),
    nvcc in parallel; returns the loaded KernelLibs by name."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, text = item
        path = build.BUILD_DIR / f"k10b_variant_{name}.cu"
        path.write_text(text)
        tag = hashlib.sha256(text.encode()).hexdigest()[:16]
        so = build.BUILD_DIR / f"libhifir_kernels_{tag}.so"
        if not so.exists():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.{name}.tmp")
            subprocess.run([build.nvcc_path(), "-gencode",
                            "arch=compute_90a,code=sm_90a", "-std=c++17",
                            "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                            str(tmp), str(path)], check=True,
                           capture_output=True, text=True)
            os.replace(tmp, so)
        return name, path

    with concurrent.futures.ThreadPoolExecutor(len(texts)) as ex:
        paths = dict(ex.map(one, texts.items()))
    libs, source = {}, build.SOURCE
    try:
        for name, path in paths.items():
            build.SOURCE = path
            build.load_kernels.cache_clear()
            libs[name] = build.load_kernels()
    finally:
        build.SOURCE = source
        build.load_kernels.cache_clear()
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k10b: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = cs.power_line()
    t0 = time.perf_counter()
    texts = variants(build.SOURCE.read_text())
    libs = build_all(texts)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    load = build.load_kernels

    def use(name):
        build.load_kernels = lambda: libs[name]

    T = cs.Timer(torch)
    D, nm, m, cb, KL, KU, live = SHAPE
    ops = cs.k10b_inputs(np.random.default_rng(11), D, nm, m, cb, KL, KU,
                         live)
    x = torch.empty(1, device="cuda")
    out = dict(smi=smi, shape=SHAPE, floor_ms=T.ms(lambda: x.fill_(1.0)),
               ms={})
    try:
        for dt in (torch.float64, torch.float32):
            dn = str(dt).removeprefix("torch.")
            use("full")
            cargs = cs.k10b_run(torch, ops, cb, dt, "convdiff-like")[0]
            for name in texts:
                use(name)
                ms = T.ms(lambda: schur.schur_partial_cuda(*cargs, cb))
                out["ms"].setdefault(dn, {})[name] = ms
                print(f"K10b warp tier {dn} {name:13s}: {ms:.4f} ms "
                      f"[{smi}]", flush=True)
    finally:
        build.load_kernels = load
    print(f"one-element fill (the timer's floor): {out['floor_ms']:.4f} ms",
          flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "probe_k10b.json"), "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
