"""What the probes in ``tools/`` time with: CUDA-event timers, the card's
name and power limit, and nvcc's register report.  The checks they share
with the card tests are in ``tests/card_common.py``."""

import re
import statistics
import subprocess

import torch


def log(*a):
    print(*a, flush=True)


def power_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class Timer:
    """CUDA-event timing: warm-up, then the median of ``iters`` launches,
    each after an L2 flush (the main path streams >100 MB of operands per
    solve, so its kernels find their inputs cold).  The flush writes 256 MB
    and so leaves L2 full of dirty lines, which the timed kernel's own
    traffic writes back; ``clean=True`` flushes by reading instead.

    A sleep kernel holds the stream while the host queues the timed
    launches, so that the card runs flush, event, launch, event back to back
    and no stall of the host falls between a pair of events (on a shared
    host such stalls inflated single-launch times several-fold)."""

    HOLD_CYCLES = 20_000_000   # ~10 ms at the H100's 1.98 GHz boost clock

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def ms(self, fn, iters=20, warmup=3, clean=False) -> float:
        flush = self.flush.sum if clean else self.flush.zero_
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(self.HOLD_CYCLES)
        pairs = []
        for _ in range(iters):
            flush()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def timed(fn, reps: int) -> float:
    """CUDA-event ms per call over ``reps`` back-to-back calls, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def ptxas_report(log_text: str) -> dict:
    """Registers, spills and shared memory of each kernel from nvcc's
    ``-Xptxas -v`` log."""
    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[name]["static_smem"] = int(m.group(1))
    return out
