"""geometry_ms.train: device milliseconds an iteration of span live_geometry
(the live branch's attached SDF and input gradient at the eikonal and traced
points, and IDR eq. 3's surface points). None where the program has no such
span or the geometry is frozen."""
from portbench.metrics._common import span_ms


def read(reading, suffix):
    return span_ms(reading, suffix, ["live_geometry"]) if suffix == "train" else None
