"""The readers of host_syncs.* and sync_idle_share.* on a hand-made
timeline: device work at 0-10, 20-30, 50-60 and 80-90 us of a 100-us
stretch, and host syncs whose host ends fall in the first gap, twice in the
second, inside busy work, and in none of the third."""

import pytest

from portbench import core
from portbench.tracing import Timeline


def _timeline(sync_ends=(15, 40, 45, 25), other_spans=(("primary_trace", 0, 95),)):
    ev = [{"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": a, "dur": 10,
           "args": {"correlation": i}} for i, a in enumerate((0, 20, 50, 80))]
    ev += [{"ph": "X", "cat": "user_annotation", "name": "host_sync.tracer.gather",
            "ts": b - 2, "dur": 2} for b in sync_ends]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
           for n, a, b in other_spans]
    return Timeline(ev, 100e-6)


def _reading(kind, timeline, n=2):
    return {"kind": kind, "timeline": timeline, "iters" if kind == "train" else "chunks": n}


@pytest.mark.parametrize("kind", ["train", "render"])
def test_host_syncs_counts_sync_spans_a_unit(kind):
    read, suffix = core.reader(f"host_syncs.{kind}")
    assert suffix == kind
    assert read(_reading(kind, _timeline()), suffix) == pytest.approx(4 / 2)


@pytest.mark.parametrize("kind", ["train", "render"])
def test_sync_idle_share_counts_a_gap_once(kind):
    """Gaps 10-20 (one sync end) and 30-50 (two) count, once each; 60-80
    holds none, and the end at 25 lies in busy work: 30 us of 100."""
    read, suffix = core.reader(f"sync_idle_share.{kind}")
    assert read(_reading(kind, _timeline()), suffix) == pytest.approx(30.0)


def test_a_sync_at_a_gap_edge_counts_it():
    read, suffix = core.reader("sync_idle_share.train")
    assert read(_reading("train", _timeline(sync_ends=(60,))), suffix) == pytest.approx(20.0)


@pytest.mark.parametrize("metric", ["host_syncs", "sync_idle_share"])
def test_a_program_without_sync_spans_reads_nothing(metric):
    """A program that marks no host sync (the parent of the spans) reads
    None, and a run of the other kind reads None."""
    for kind in ("train", "render"):
        read, suffix = core.reader(f"{metric}.{kind}")
        assert read(_reading(kind, _timeline(sync_ends=())), suffix) is None
        other = "render" if kind == "train" else "train"
        assert read(_reading(other, _timeline()), suffix) is None
