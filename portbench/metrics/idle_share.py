"""idle_share.train / .render: 1 - the union of the device's operations
(kernels, copies, sets) over the traced stretch's wall time, in percent."""
from portbench.metrics._common import per


def read(reading, suffix):
    if per(reading, suffix) is None:
        return None
    t = reading["timeline"]
    return 100.0 * (1.0 - t.busy_s() / t.wall_s)
