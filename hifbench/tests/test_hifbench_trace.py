"""The trace's reduction on fake records."""

import pytest

from hifbench.trace import (TAKES, WINDOW_SPAN, complete, counters,
                            kernel_name, reduce_trace, take_pad)

MS = 1_000_000


def test_busy_union_idle_and_names():
    recs = [
        (WINDOW_SPAN, False, 0, 100 * MS),
        ("hifbench.apply.call", False, 0, 50 * MS),
        ("hifbench.apply.call", False, 50 * MS, 100 * MS),
        ("cudaGraphLaunch", False, 1 * MS, 2 * MS),
        ("cudaStreamSynchronize", False, 2 * MS, 45 * MS),
        ("cudaGraphLaunch", False, 60 * MS, 70 * MS),
        ("void trsv_solve_kernel<float, 8>(...)", True, 3 * MS, 30 * MS),
        ("void trsv_solve_kernel<float, 8>(...)", True, 25 * MS, 40 * MS),
        ("Memcpy DtoD (Device -> Device)", True, 40 * MS, 41 * MS),
        ("void sell_wide_kernel<float>(...)", True, 80 * MS, 120 * MS),
        ("ProfilerStep#1", True, 0, 100 * MS),
        ("hifbench.window", True, 0, 100 * MS),
    ]
    t = reduce_trace(recs)
    assert t.window_s == pytest.approx(0.1)
    # [3, 41] and [80, 100] (clipped to the window)
    assert t.busy_s == pytest.approx(0.038 + 0.020)
    assert t.count_of("trsv_solve_kernel") == 2
    assert t.seconds_of("trsv_solve_kernel") == pytest.approx(0.042)
    assert t.seconds_of("sell_wide_kernel") == pytest.approx(0.020)
    assert sum(t.idle_by_host.values()) == pytest.approx(0.1 - 0.058)
    # the gaps [0, 3] and [41, 80] have their middles (1.5 and 60.5 ms)
    # in a call's graph launch
    assert t.idle_by_host == {
        "hifbench.apply.call/cudaGraphLaunch": pytest.approx(0.042)}


def test_kernel_names():
    assert kernel_name("void trsv_solve_kernel<double, 4, true>(x)") == \
        "trsv_solve_kernel"
    assert len(kernel_name("x" * 200)) == 70
    assert kernel_name("void at::native::elementwise_kernel<128, 4>(int)") \
        == "at::native::elementwise_kernel"
    assert kernel_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
    # the program's kernels live in anonymous namespaces
    assert kernel_name("void (anonymous namespace)::trsv_solve_kernel<float,"
                       " 8, true>(int, float const*)") == "trsv_solve_kernel"
    assert kernel_name("void at::native::(anonymous namespace)::k<4>(int)") \
        == "at::native::k"
    assert kernel_name("sm90_xmma_gemm_f64f64") == "sm90_xmma_gemm_f64f64"


def test_retakes_and_the_gate_on_lost_records():
    assert [take_pad(t) for t in (1, 2, 3)] == [0.1, 0.2, 0.4]
    assert TAKES >= 3

    class Meter:
        @staticmethod
        def counters():
            return {"trsv_solve_kernel": 3}

    assert counters([Meter, object()]) == {"trsv_solve_kernel": 3}
    recs = [(WINDOW_SPAN, False, 0, 10 * MS),
            ("void trsv_solve_kernel<float, 8>(...)", True, MS, 2 * MS),
            ("void trsv_solve_kernel<float, 8>(...)", True, 3 * MS, 4 * MS)]
    t = reduce_trace(recs)
    assert complete(t, {"trsv_solve_kernel": 2})
    assert not complete(t, {"trsv_solve_kernel": 3})
    assert complete(t, {})
