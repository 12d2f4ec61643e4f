#!/usr/bin/env python3
"""Can a program over several cards be captured as one CUDA graph?

Run from the root of a checkout on a machine with NVIDIA GPUs:

    python3 tools/probe_mesh_graph.py [--out DIR]

The distributed jit sites (``DistPrec.solve`` and the mesh's programs)
are captured through ``hifir_tpu_torch.graphs``; on a mesh over several
cards that is :class:`~hifir_tpu_torch.graphs.MultiCardGraphs`, design (a):
one capture on the first card's stream that forks every other card's
stream through events, the other cards' allocations routed to a pool of
the capture's id (``torch._C._cuda_beginAllocateCurrentThreadToPool``).
The probe decides whether (a) works on this machine, over 4 cards (2 with
two or three; with one card, the two groups of one card):

1. the collectives alone: a program that replicates an input to every
   group, scales each group's copy, all_gathers, shifts around the ring
   and collects on the first card, captured once and replayed on three
   other inputs, each replay against the eager program bit for bit, with
   the pool's bytes on every card;
2. ``DistPrec`` on poisson2d(64) (the JAX distribution tests' options,
   chunk 64, eight ranks) in the peer form (halo and all_gather) and the
   chunk form: the replay against the eager solve bit for bit and the
   host solve (1e-12), and four eager and four replayed peer-form solves
   interleaved, every wait polled with a deadline.

Design (b), one graph a card ordered by external events, is tried only
where (a) fails: a graph a card, each running a kernel, the second
waiting on an external event the first records.  Prints one line a check
and the choice; the multi-card legs' replays of the four-card peer and
chunk forms are card tests (``tests/test_torch_dist_card.py -k cards``).
``--out DIR`` writes ``DIR/probe_mesh_graph.json``.
"""

import argparse
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from card_common import RED_OPTS, sync_all  # noqa: E402
from probe_util import log, power_line  # noqa: E402


def pool_bytes_by_card(pool) -> dict:
    """Bytes of the allocator's segments in pool ``pool``, by card."""
    out = {}
    for s in torch.cuda.memory_snapshot():
        if tuple(s.get("segment_pool_id", ())) == tuple(pool):
            out[s["device"]] = out.get(s["device"], 0) + s["total_size"]
    return out


def collectives(mesh, b):
    """The mesh's collectives in one program: replicate, scale each group,
    all_gather, ring shift, collect on the first group's card."""
    xs = mesh.replicate(b)
    xs = [x * (i + 2) for i, x in enumerate(xs)]
    full = mesh.all_gather([x[:, :8] for x in xs])
    ring = mesh.shift(full, 1, ring=True)
    return mesh.collect([r[:, :16] + f[:, 8:24] for r, f in zip(ring, full)])


def check_collectives(mesh) -> dict:
    from hifir_tpu_torch import graphs

    cache = graphs.cache_of(mesh)
    rng = np.random.default_rng(3)
    inputs = [torch.as_tensor(rng.standard_normal(64), device=mesh.device)
              for _ in range(4)]
    t0 = time.perf_counter()
    cache.call(collectives, mesh, inputs[0])      # warm-up and capture
    sync_all()
    first = time.perf_counter() - t0
    equal = []
    for b in inputs[1:]:
        y = cache.call(collectives, mesh, b)
        sync_all()
        equal.append(bool(torch.equal(y, collectives(mesh, b))))
    return dict(backend=type(cache.backend).__name__, bit_equal=equal,
                first_call_seconds=first,
                pool_bytes=pool_bytes_by_card(cache.backend.pool))


def check_distprec(mesh, P, b, xh) -> dict:
    from hifir_tpu_torch.parallel import DistPrec

    out = {}
    xmax = np.abs(xh).max()
    for name, kw in (("peer halo", {}), ("peer all_gather", dict(halo=False)),
                     ("chunk halo", dict(form="chunk"))):
        dp = DistPrec.from_host(mesh, P, chunk=64, **kw)
        dp.graphs = False
        xe = dp.solve(b)
        sync_all()
        dp.graphs = True
        t0 = time.perf_counter()
        dp.solve(b)
        sync_all()
        first = time.perf_counter() - t0
        xr = dp.solve(b)
        sync_all()
        xs = []
        if name == "peer halo":
            for _ in range(4):
                for on in (False, True):
                    dp.graphs = on
                    xs.append(dp.solve(b))
                    sync_all()
        forms = sorted({op.plan.form for lv in dp.levels
                        for op in (lv.L_op, lv.U_op) if op.nchunks})
        ent = next(iter(dp.graph_cache.entries.values()))
        out[name] = dict(
            forms=forms, bit_equal=bool(torch.equal(xr, xe)),
            err_vs_host=float(np.abs(xr.cpu().numpy() - xh).max() / xmax),
            interleaved_bit_equal=all(bool(torch.equal(x, xe)) for x in xs),
            first_call_seconds=first, capture_seconds=ent.seconds,
            pool_bytes=pool_bytes_by_card(dp.graph_cache.backend.pool))
    return out


def design_b(cards) -> dict:
    """One graph a card, the second waiting on an external event that the
    first records; both replayed before anything waits."""
    ev = torch.cuda.Event(external=True)
    xs = [torch.ones(1 << 20, device=f"cuda:{c}") for c in cards[:2]]
    gs = []
    for i, (c, x) in enumerate(zip(cards[:2], xs)):
        s = torch.cuda.Stream(c)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.device(c), torch.cuda.stream(s):
            x.mul_(2)      # warm-up outside the capture
            torch.cuda.synchronize(c)
            g.capture_begin()
            if i:
                s.wait_event(ev)
            x.mul_(2)
            if not i:
                ev.record(s)
            g.capture_end()
        gs.append(g)
    for c, g in zip(cards[:2], gs):
        with torch.cuda.device(c):
            g.replay()
    sync_all()
    return dict(ok=all(float(x[0]) == 8.0 for x in xs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_mesh_graph: no CUDA device", file=sys.stderr)
        return 2

    import hifir_tpu_torch as ht
    from hifir_tpu_torch.kernels.build import load_kernels
    from hifir_tpu_torch.models.problems import poisson2d
    from hifir_tpu_torch.native.build import load_native
    from hifir_tpu_torch.parallel import make_mesh

    smi = power_line()
    count = torch.cuda.device_count()
    out = dict(nvidia_smi=smi, cards=count, torch=torch.__version__,
               cuda=torch.version.cuda,
               thread_pool_routing=hasattr(
                   torch._C, "_cuda_beginAllocateCurrentThreadToPool"))
    t0 = time.perf_counter()
    load_kernels()
    load_native()
    log(f"build {time.perf_counter() - t0:.1f} s; torch {torch.__version__}"
           f" CUDA {torch.version.cuda}; {count} cards [{smi}]")
    k = 1 if count == 1 else (4 if count >= 4 else 2)
    cards = list(range(k))
    devices = ([f"cuda:{c}" for c in cards for _ in range(8 // k)] if k > 1
               else ["cuda:0"] * 4 + ["cuda"] * 4)
    mesh = make_mesh(devices=devices)
    out["layout"] = [str(g.device) for g in mesh.groups()]
    checks = {}
    try:
        checks["collectives"] = check_collectives(mesh)
        log(f"(a) collectives over {out['layout']}: "
               f"{checks['collectives']}")
        A = poisson2d(64)
        P = ht.HIF().factorize(A, ht.Options(**RED_OPTS), device="cuda")
        b = np.random.default_rng(6).standard_normal(A.nrows)
        checks["distprec"] = check_distprec(mesh, P, b, P.solve(b))
        for name, r in checks["distprec"].items():
            log(f"(a) DistPrec poisson2d(64) {name}: {r} [{smi}]")
        ok = all(checks["collectives"]["bit_equal"]) and all(
            r["bit_equal"] and r["interleaved_bit_equal"]
            and r["err_vs_host"] <= 1e-12
            for r in checks["distprec"].values())
        out["design_a"] = dict(ok=ok, **checks)
    except Exception as e:      # the probe's finding, reported
        out["design_a"] = dict(ok=False, error=f"{type(e).__name__}: {e}",
                               trace=traceback.format_exc(), **checks)
        log(f"(a) failed: {type(e).__name__}: {e}")
    if not out["design_a"]["ok"] and k > 1:
        try:
            out["design_b"] = design_b(cards)
        except Exception as e:
            out["design_b"] = dict(ok=False,
                                   error=f"{type(e).__name__}: {e}")
        log(f"(b) {out['design_b']}")
    else:
        out["design_b"] = "not tried: design (a) captured every program"
    out["choice"] = ("a" if out["design_a"]["ok"] else
                     "b" if isinstance(out["design_b"], dict)
                     and out["design_b"].get("ok") else "neither")
    log(f"choice: {out['choice']}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "probe_mesh_graph.json"), "w") as f:
            json.dump(out, f, indent=1, default=str)
    print(smi)
    print(json.dumps({"ok": out["choice"] != "neither",
                      "choice": out["choice"]}))
    return 0 if out["choice"] != "neither" else 1


if __name__ == "__main__":
    sys.exit(main())
