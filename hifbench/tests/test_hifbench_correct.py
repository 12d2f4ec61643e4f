"""What decides ``correct``, driven on the CPU at a small size: the rest of
a run past the look for a card, sound and with the timed path broken
underneath, and the control (the reference in the precision below the
configuration's), which has to come out not correct."""

import io
import json
import time

import pytest

from hifbench import compare, control, spec
from hifbench import run as runner

SEED = 2 ** 31 + 11


def one_run(cell, trace=0):
    args = runner.parse(["--workload", cell.name, "--seed", str(SEED),
                         "--seconds", "0.5", "--trace", str(trace)])
    out = io.StringIO()
    rc = runner.run(args, cell=cell, device="cpu", t0=time.perf_counter(),
                    out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["p2d1m.apply64", "p3d64.gmres1"])
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(small_cell, name, trace):
    res = one_run(small_cell(name), trace)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    if trace:
        assert "breakdown" in res and "window_s" in res["device"]
        assert res["metrics"]["factorize_s"]["value"] > 0
    else:
        cell = small_cell(name)
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in res["metrics"].values())


def bump_row(X):
    X = X.clone()
    X[3] += 1e-2 * X.abs().max()
    return X


def drop_half(X):
    X = X.clone()
    X[:, X.shape[1] // 2:] = 0
    return X


@pytest.mark.parametrize("fault", [bump_row, drop_half])
def test_broken_apply_is_not_correct(small_cell, monkeypatch, fault):
    from hifir_tpu_torch.alg.prec import DevicePrec

    orig = DevicePrec.solve_mrhs
    monkeypatch.setattr(DevicePrec, "solve_mrhs",
                        lambda self, B, *a, **k: fault(orig(self, B, *a,
                                                            **k)))
    assert one_run(small_cell("p2d1m.apply64"))["correct"] is False


def altered(x, flag, it):
    x = x.clone()
    x[3] += 1e-2 * x.abs().max()
    return x, flag, it


def unchanged(x, flag, it):
    return x * 0, flag, it


@pytest.mark.parametrize("fault", [altered, unchanged])
def test_broken_gmres_is_not_correct(small_cell, monkeypatch, fault):
    import hifir_tpu_torch as ht

    orig = ht.gmres_hif
    monkeypatch.setattr(ht, "gmres_hif", lambda *a, **k: fault(*orig(*a,
                                                                     **k)))
    assert one_run(small_cell("p3d64.gmres1"))["correct"] is False


@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_control_is_not_correct(small_cell, name):
    cell = small_cell(name)
    recs = control.readings(cell, [SEED, 5], [6, 7, SEED + 1], 0.3,
                            device="cpu", out=io.StringIO())
    sound = [r for r in recs if r.get("control") is False]
    ctl = [r for r in recs if r.get("control")]
    faults = [r for r in recs if "fault" in r]
    assert {r["fault"] for r in faults} == {"weak", "p_rolled", "E_dropped"}
    assert all(r["correct"] for r in sound)
    assert not any(r["correct"] for r in ctl)
    # every planted fault in the factorization fails one of its numbers
    for r in faults:
        assert not compare.verdict(r["values"], cell.limits)[0], r
    # the weak factorize fills less
    weak = [r for r in faults if r["fault"] == "weak"]
    assert all(r["structure"]["fill"] < cell.config["stated"]["fill"]
               for r in weak)
    # the control reads three times the program's worst or more
    worst = max(r["values"]["x_gap"] for r in sound)
    assert min(r["values"]["x_gap"] for r in ctl) >= 3 * worst


@pytest.mark.parametrize("lost_takes", [1, 99])
def test_a_trace_that_lost_records_is_taken_again(small_cell, monkeypatch,
                                                  lost_takes):
    """The counters claim a launch the trace lacks in the first
    ``lost_takes`` takes: each is taken again with twice the pads, up to
    ``TAKES`` in all."""
    from hifbench import trace as tr

    pads, orig, takes = [], tr.profiled, iter(range(1000))

    def profiled(body, pad):
        pads.append(pad)
        return orig(body, pad)

    def counters(modules):
        i = next(takes)     # two reads a take: before and after
        return {"lost_kernel": int(i % 2 and i // 2 < lost_takes)}

    monkeypatch.setattr(tr, "profiled", profiled)
    monkeypatch.setattr(tr, "counters", counters)
    res = one_run(small_cell("p2d1m.apply64"), trace=1)
    n = min(lost_takes + 1, tr.TAKES)
    assert pads == [tr.take_pad(t) for t in range(1, n + 1)]
    assert res["correct"] is True
