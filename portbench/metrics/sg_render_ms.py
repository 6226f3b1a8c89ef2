"""sg_render_ms.train: device milliseconds an iteration of span sg_render
(the closed-form SG render, ops/sg.py render_with_sg). None where the
program has no such span or renders by path tracing."""
from portbench.metrics._common import span_ms


def read(reading, suffix):
    return span_ms(reading, suffix, ["sg_render"]) if suffix == "train" else None
