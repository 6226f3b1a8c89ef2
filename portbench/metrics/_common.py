"""Helpers of the per-layer readers. A reader gets the traced run's reading
(a dict: kind "train" or "render", the stretch's timeline, its iterations or
chunks, the kernel rows, the SDF net's layer shapes and the reference's
work counts) and the metric's suffix, and returns the value or None when
the run has nothing to read for it."""


def per(reading, suffix):
    """Iterations or chunks of the stretch, or None when the suffix is not
    the run's kind."""
    if reading is None or reading.get("kind") != suffix:
        return None
    n = reading["iters"] if suffix == "train" else reading["chunks"]
    return n or None


def span_ms(reading, suffix, names):
    n = per(reading, suffix)
    if n is None:
        return None
    parts = [reading["timeline"].span_device_s(s) for s in names]
    parts = [x for x in parts if x is not None]
    if not parts:
        return None
    return sum(parts) * 1e3 / n


def roofline(reading, suffix, kernel, substring):
    if per(reading, suffix) is None:
        return None
    bound, launches = reading["rows"].bound_s(kernel, reading["shapes"])
    seconds, count = reading["timeline"].kernel_s(substring)
    if launches == 0 or seconds <= 0:
        return None
    return 100.0 * bound / seconds
