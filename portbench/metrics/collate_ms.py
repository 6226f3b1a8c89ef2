"""collate_ms.train: host milliseconds an iteration of the dataset's
collate and the runner's _device_inputs, on the harness's clock with a
synchronise on either side (the traced stretch)."""
from portbench.metrics._common import per


def read(reading, suffix):
    n = per(reading, suffix) if suffix == "train" else None
    return None if n is None else reading["collate_s"] * 1e3 / n
