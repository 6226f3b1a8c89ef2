"""sync_idle_share.train / .render: the device's idle time that a host sync
causes, in percent of the traced stretch's wall time: the gaps between the
union's busy intervals that hold the host end of at least one span named
host_sync.<site>, each gap counted once, summed. Beside idle_share it splits
the idle time into the part after a sync (the host waited for the queue to
drain, then refilled it) and the rest. None where the program marks no host
sync."""
import bisect

from portbench.metrics._common import per

PREFIX = "host_sync."


def read(reading, suffix):
    if per(reading, suffix) is None:
        return None
    t = reading["timeline"]
    ends = sorted(b for name, iv in t.spans.items() if name.startswith(PREFIX) for _, b in iv)
    if not ends:
        return None
    kept = 0.0
    for (_, g0), (g1, _) in zip(t.busy, t.busy[1:]):
        i = bisect.bisect_left(ends, g0)
        if i < len(ends) and ends[i] <= g1:
            kept += g1 - g0
    return 100.0 * kept / 1e6 / t.wall_s
