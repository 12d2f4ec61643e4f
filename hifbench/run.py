#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the card this machine holds:

    python3 hifbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (``setup_s``, from this process's start): the cell's files, the
matrix, the host factorize (``factorize_s``, reported in the traced run),
the pack, the inputs from the seed, the cell's one shape warmed and
captured.  Then the measured window:
``--seconds`` of one client's back-to-back requests, the program's calls
only.  With ``--trace 1`` the window runs under torch.profiler with the
benchmark's spans and reports the per-layer metrics instead of the
end-to-end ones.  Then the checks: sampled answers against the plain
reference, after the device memory's peak has been read and the program's
state freed.  The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the last key of that object.  Without a card, or with fewer
cards than the cell asks for, it exits 2 and prints no result; if jax,
jaxlib, flax or hifir_tpu are loaded once the window has closed, it exits 3
and prints no result."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "hifir_tpu")
# a traced window is taken again (its trace lost records) only while the
# run would still end by this many seconds from its start, its reference
# after the window included, well inside the 360 a run may take
RETAKE_S = 240


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_missing(torch, chips: int):
    if not torch.cuda.is_available():
        return "no CUDA device: this benchmark runs on the card only"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards, the machine has "
                f"{torch.cuda.device_count()}")
    return None


def run(args, cell=None, device="cuda", t0=T0, out=None) -> int:
    """One run; ``cell`` and ``device`` let the tests drive the rest of a
    run on the CPU at a small size, past the look for a card."""
    import torch

    from hifbench import compare, problems, program, reference, spec
    from hifbench import trace as tr
    from hifbench.window import closed_loop

    out = out or sys.stdout
    if cell is None:
        cell = spec.resolve(spec.load_benchmark(), args.workload)
        missing = card_missing(torch, cell.chips)
        if missing:
            print(missing, file=sys.stderr)
            return 2
    on_card = torch.device(device).type == "cuda"
    drv = spec.load_module(cell.driver)
    A = problems.make(cell.config)
    c = drv.Cell(cell.config, cell.traffic, A, device, args.seed,
                 args.seconds)
    setup_s = time.perf_counter() - t0

    spans = tr.Spans(bool(args.trace))

    def loop():
        return closed_loop(lambda i: c.request(i, spans), args.seconds)

    if args.trace:
        c.count_syncs = on_card
        meters = [drv] + [spec.load_module(spec.metric_file(m["name"]))
                          for m in cell.per_layer]

        def body():
            with spans(tr.WINDOW_SPAN):
                return loop()

        for take in range(1, tr.TAKES + 1):
            if take > 1:
                c.reset(args.seed, args.seconds)
            before = tr.counters(meters)
            win, recs = tr.profiled(body, tr.take_pad(take))
            after = tr.counters(meters)
            counted = {k: after[k] - before[k] for k in after}
            dt = tr.reduce_trace(recs)
            whole = tr.complete(dt, counted)
            # another take only while one more window fits the run's time
            if whole or time.perf_counter() - t0 + 2 * win.seconds > RETAKE_S:
                break
        if not whole:
            print(f"the trace lost device records in {take} takes: "
                  f"counted {counted}, traced "
                  f"{ {k: dt.count_of(k) for k in counted} }", file=sys.stderr)
    else:
        win = loop()
    program.sync(torch, device)
    attempted, failed = c.counts(win)
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    metrics, extra = {}, {}
    if not args.trace:
        vals = dict(c.end_to_end(win), setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}
    else:
        ctx = dict(c.layer_context(win), levels=c.levels, n=A.shape[0],
                   tail_n=0 if c.tail is None else c.tail.shape[0],
                   trace=dt if whole else None, counted=counted,
                   factorize_s=c.factorize_s)
        for m in cell.per_layer:
            v = spec.load_module(spec.metric_file(m["name"])).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        extra = dict(busy_s=dt.busy_s, window_s=dt.window_s)
        top = sorted(dt.by_name.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(dt.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        breakdown = {"device_ops": [[k, s] for k, (s, _) in top],
                     "idle_gaps": [[k, s] for k, s in gaps]}

    items = c.sample(win)
    c.free()
    P = reference.Prec(c.levels, c.tail)
    values = drv.judge(items, P, A, cell.traffic)
    values.update(compare.factorization(c.levels, c.tail, A,
                                        cell.config["stated"], args.seed,
                                        P=P))
    values["failed"] = failed
    correct, checks = compare.verdict(values, cell.limits)

    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": dict(platform="gpu" if on_card else "cpu",
                             kind=(torch.cuda.get_device_name(0) if on_card
                                   else "cpu"),
                             count=cell.chips, memory_peak_bytes=peak,
                             **extra)}
    if args.trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run(parse()))
