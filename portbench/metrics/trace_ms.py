"""trace_ms.train / trace_ms.render: device milliseconds of span
primary_trace an iteration or a chunk."""
from portbench.metrics._common import span_ms


def read(reading, suffix):
    return span_ms(reading, suffix, ["primary_trace"])
