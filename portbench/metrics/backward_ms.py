"""backward_ms.train: device milliseconds an iteration of span train.backward."""
from portbench.metrics._common import span_ms


def read(reading, suffix):
    return span_ms(reading, suffix, ["train.backward"]) if suffix == "train" else None
