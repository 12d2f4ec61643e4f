"""``k2_tile_pct``: K2's launches in the tile form over all its launches in
the last take, on fake snapshots of the program's counters, and nothing on a
program without the tile counter or without the window."""

import pytest

from hifbench import program_trace, spec

TILE = "trsv_apply_cuda.tile_launches"
ALL = "trsv_apply_cuda.launches"


def metric():
    return spec.load_module(spec.metric_file("k2_tile_pct"))


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


@pytest.mark.parametrize("name", ["k2_tile_pct.apply", "k2_tile_pct.gmres"])
def test_both_entries_load_the_one_reader(name):
    assert spec.metric_file(name) == spec.metric_file("k2_tile_pct")


@pytest.mark.parametrize("before,after,ctx,want", [
    # the 1M pack's 12 K2 launches a call, 10 of them tiles, over 3 calls
    ({ALL: 12, TILE: 10}, {ALL: 48, TILE: 40}, {"solves": 3}, 100.0 * 10 / 12),
    # single-RHS solves never take the tile form
    ({ALL: 8, TILE: 0}, {ALL: 248, TILE: 0}, {"solves": 30}, 0.0),
])
def test_reads_the_last_take(fake, before, after, ctx, want):
    """The hook marks before and after each take and holds the trace to
    nothing; ``read`` takes the last two marks, loaded afresh as the
    harness loads it."""
    first = snap(**{k: 0 for k in before})
    fake(first, first, snap(**before), snap(**after))
    hook = metric()
    for _ in range(4):          # two takes
        assert hook.counters() == {}
    assert metric().read(ctx) == pytest.approx(want)


def test_reads_nothing_without_the_window(fake):
    fake(snap(), snap())
    mod = metric()
    assert mod.read({"solves": 3}) is None        # never marked
    mod.counters()
    mod.counters()
    assert mod.read({"solves": 3}) is None        # no such counter


def test_reads_nothing_from_a_program_without_tiles(fake):
    """A program from before the tile form counts K2's launches and no
    tile launches: the metric reads nothing and does not raise."""
    fake(snap(**{ALL: 12}), snap(**{ALL: 48}))
    mod = metric()
    mod.counters()
    mod.counters()
    assert metric().read({"solves": 3}) is None


def test_reads_nothing_without_a_k2_launch(fake):
    """A window in which K2 never ran gives no share, not a division by
    zero."""
    fake(snap(**{ALL: 5, TILE: 0}), snap(**{ALL: 5, TILE: 0}))
    mod = metric()
    mod.counters()
    mod.counters()
    assert mod.read({"solves": 3}) is None
