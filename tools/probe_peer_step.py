#!/usr/bin/env python3
"""The peer sweep's chunk step taken apart on one card.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/probe_peer_step.py [--nx 512] [--out DIR]

It builds ``csrc/kernels.cu`` and variants of it, made from the source by
text substitution in the peer sweep's flag exchange alone
(``chunk_sweep_kernel``'s ``sync_groups``), each nvcc in parallel into
``build/hifir_tpu_torch/``:

- ``release``: ``st.release.sys`` after the fence, as first written (the
  store's own release repeats the fence);
- ``gpu``: the fence, the stores and the acquire loads at GPU scope
  instead of system scope (right on one card only);
- ``nofence``: no ``fence.acq_rel.sys`` before the relaxed stores (no
  release: its results are not checked; it times the fence);
- ``noflags``: no flag exchange at all, only the ``__syncthreads`` (the
  groups then race: its results are not checked; it times the rest).

On poisson2d(nx)'s ``DistPrec`` (chunk 1024, eight ranks, f64) it times
one application of level 0's L (all_gather form) by CUDA events, each
after the Timer's L2 flush (``chip_smoke.Timer``): the one-group sweep on
eight ranks of the card, and every variant of the peer sweep on two groups
of four (``"cuda:0"`` and ``"cuda"``), after holding the real kernel,
``release`` and ``gpu`` against the plain version (1e-12).  The
differences say where a peer step's time goes; ``--out DIR`` writes
``DIR/probe_peer_step.json``.
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
from hifir_tpu_torch.ops import chunk  # noqa: E402

FENCE = '      asm volatile("fence.acq_rel.sys;\\n" ::: "memory");\n'
STORE = '"st.relaxed.sys.global.u64 [%0], %1;\\n"'
LOAD = '"ld.acquire.sys.global.u64 %0, [%1];\\n"'
SYNC = """    if (leader) {
      asm volatile("fence.acq_rel.sys;\\n" ::: "memory");
      for (int h = 0; h < G; ++h)
        if (h != g) st_relaxed_sys(a.flags[h] + g, v);
    }
    if (threadIdx.x == 0) {
      const unsigned long long t0 = globaltimer_ns();
      for (int h = 0; h < G; ++h)
        while (h != g && ld_acquire_sys(a.flags[g] + h) < v)
          if (globaltimer_ns() - t0 > kPeerWaitNs) __trap();
    }
"""


def variants(src: str) -> dict:
    for s in (FENCE, STORE, LOAD, SYNC):
        if src.count(s) != 1:
            raise RuntimeError(f"probe_peer_step: the peer sweep changed; "
                               f"{s.strip()[:40]!r} not found once")
    return {"full": src,
            "gpu": src.replace(FENCE, FENCE.replace(".sys", ".gpu"))
            .replace(STORE, STORE.replace(".sys", ".gpu"))
            .replace(LOAD, LOAD.replace(".sys", ".gpu")),
            "release": src.replace(STORE, STORE.replace("relaxed",
                                                        "release")),
            "nofence": src.replace(FENCE, ""),
            "noflags": src.replace(SYNC, "    (void)v;\n")}


def build_all(texts: dict) -> dict:
    """Each variant's library (hash-named as ``load_kernels`` names them),
    nvcc in parallel; returns the loaded KernelLibs by name."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, text = item
        path = build.BUILD_DIR / f"peer_variant_{name}.cu"
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
        print("probe_peer_step: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nx", type=int, default=cs.DIST_NX)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import hifir_tpu_torch as ht
    from hifir_tpu_torch.models.problems import poisson2d
    from hifir_tpu_torch.native.build import load_native
    from hifir_tpu_torch.parallel import DistPrec, make_mesh

    smi = cs.power_line()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        fl = ex.submit(build_all, variants(build.SOURCE.read_text()))
        ex.submit(load_native).result()
        libs = fl.result()
    cs.log(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} "
           f"s [{smi}]")

    def use(name):
        build.load_kernels = chunk.load_kernels = lambda: libs[name]

    A = poisson2d(args.nx)
    P = ht.HIF().factorize(A, ht.Options(verbose=0), device="cuda")
    T = cs.Timer(torch)
    rng = np.random.default_rng(14)
    out = dict(nvidia_smi=smi, nx=args.nx, ms={}, vs_plain={})
    use("full")
    one = DistPrec.from_host(make_mesh(8), P, chunk=cs.DIST_CHUNK,
                             max_halo_chunks=128)
    sw, x0, xk, xp = cs.sweep_pair(torch, rng, one.levels[0].L_op,
                                   torch.float64)
    out["vs_plain"]["one group"] = cs.rel_diff(xk, xp)
    x = x0.clone()
    out["ms"]["one group"] = T.ms(lambda: chunk.chunk_sweep(x, sw))
    out["chunks"] = sw.nchunks
    mesh2 = make_mesh(devices=["cuda:0"] * 4 + ["cuda"] * 4)
    for name in libs:
        use(name)
        dp = DistPrec.from_host(mesh2, P, chunk=cs.DIST_CHUNK,
                                max_halo_chunks=128)
        plan, x0, Y, Yp = cs.peer_pair(torch, rng, dp.levels[0].L_op,
                                       torch.float64)
        err = cs.rel_diff(Y, Yp)
        out["vs_plain"][name] = err
        if name in ("full", "release", "gpu"):
            cs.gate(err <= 1e-12, f"{name}: vs plain {err:.3e}")
        xs = [x.clone() for x in x0]
        out["ms"][name] = T.ms(lambda: chunk.chunk_sweep_peer(xs, plan))
    for name, ms in out["ms"].items():
        cs.log(f"level-0 L, {out['chunks']} chunks, {name:9s}: {ms:.4f} ms, "
               f"{ms * 1e3 / out['chunks']:.3f} us a step; vs plain "
               f"{out['vs_plain'][name]:.3e} [{smi}]")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "probe_peer_step.json"), "w") as f:
            json.dump(out, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
