"""secondary_ms.train / .render: device milliseconds of spans
secondary_trace and secondary_shading an iteration or a chunk (in training
the distillation step's included)."""
from portbench.metrics._common import span_ms


def read(reading, suffix):
    return span_ms(reading, suffix, ["secondary_trace", "secondary_shading"])
