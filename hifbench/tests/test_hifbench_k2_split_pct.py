"""``k2_split_pct``: K2's launches of one column on a cluster over all its
launches in the last take, on fake snapshots of the program's counters,
and nothing on a program without the split counter, without the window or
without a K2 launch."""

import pytest

from hifbench import program_trace, spec

ALL = "trsv_apply_cuda.launches"
SPLIT = "trsv_apply_cuda.split_launches"


def metric():
    return spec.load_module(spec.metric_file("k2_split_pct"))


def snap(**counters):
    return {"spans": {}, "counters": counters}


@pytest.fixture
def fake(monkeypatch):
    """``fake(*snapshots)``: the program's snapshots, one a call."""
    monkeypatch.setattr(program_trace, "_MARKS", {})

    def feed(*snaps):
        it = iter(snaps)
        monkeypatch.setattr(program_trace, "snapshot", lambda: next(it))

    return feed


def test_the_entry_loads_its_one_reader():
    assert spec.metric_file("k2_split_pct.gmres") == \
        spec.metric_file("k2_split_pct")


@pytest.mark.parametrize("before,after,want", [
    # the gmres cell's M-solve: 4 launches, level 0's L and U split
    ({ALL: 8, SPLIT: 4}, {ALL: 248, SPLIT: 124}, 50.0),
    # a block solve never splits
    ({ALL: 12, SPLIT: 0}, {ALL: 48, SPLIT: 0}, 0.0),
    # one split launch of three
    ({ALL: 3, SPLIT: 1}, {ALL: 33, SPLIT: 11}, 100.0 * 10 / 30),
])
def test_reads_the_last_take(fake, before, after, want):
    """The hook marks before and after each take and holds the trace to
    nothing; ``read`` takes the last two marks, loaded afresh as the
    harness loads it."""
    first = snap(**{k: 0 for k in before})
    fake(first, first, snap(**before), snap(**after))
    hook = metric()
    for _ in range(4):          # two takes
        assert hook.counters() == {}
    assert metric().read({}) == pytest.approx(want)


def test_reads_nothing_without_the_window(fake):
    fake(snap(), snap())
    mod = metric()
    assert mod.read({}) is None                   # never marked
    mod.counters()
    mod.counters()
    assert mod.read({}) is None                   # no such counter


def test_reads_nothing_from_a_program_without_the_counter(fake):
    """A program from before the split counts K2's launches, tiles, levels
    and shared-memory launches, not its split launches: the metric reads
    nothing and does not raise."""
    old = {ALL: 8, "trsv_apply_cuda.tile_launches": 0,
           "trsv_apply_cuda.levels": 6120,
           "trsv_apply_cuda.smem_launches": 0}
    fake(snap(**old), snap(**{k: 31 * v for k, v in old.items()}))
    mod = metric()
    mod.counters()
    mod.counters()
    assert metric().read({}) is None


def test_reads_nothing_without_a_k2_launch(fake):
    """A window in which K2 never ran gives no reading, not a division by
    zero."""
    fake(snap(**{ALL: 5, SPLIT: 3}), snap(**{ALL: 5, SPLIT: 3}))
    mod = metric()
    mod.counters()
    mod.counters()
    assert mod.read({}) is None
