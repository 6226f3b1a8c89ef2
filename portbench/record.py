"""What the check takes from the program while the steps or chunks it
follows run: the primary trace, and in order every Monte-Carlo direction
the path tracer drew and every secondary trace it ran. Installed for those
calls only; it keeps references to the tensors the program made and copies
nothing, so the calls it watches run as they would without it.
"""

from __future__ import annotations

from typing import List


class _Tracer:
    def __init__(self, tracer, sink: List, primary: bool):
        self._tracer, self._sink, self._primary = tracer, sink, primary

    def __getattr__(self, name):
        return getattr(self._tracer, name)

    def __call__(self, sdf_fn, cam_loc, object_mask, ray_directions, *args, **kwargs):
        res = self._tracer(sdf_fn, cam_loc, object_mask, ray_directions, *args, **kwargs)
        if self._primary:
            self._sink.append((res.points, res.object_mask, res.dists))
        else:
            self._sink.append(("trace", cam_loc, ray_directions.reshape(-1, 3), res.points,
                               res.object_mask, res.dists))
        return res


class Recorder:
    """with Recorder(model, path_tracing_module) as rec: ... -> rec.primary
    [(points, hit, dists)], rec.events [("draw", name, wi) | ("trace", ...)]."""

    def __init__(self, model, path_tracing):
        self.model, self.pt = model, path_tracing
        self.primary: List = []
        self.events: List = []

    def __enter__(self):
        m = self.model
        self._saved = (m.ray_tracer, m.secondary_ray_tracer, self.pt.sample_direction)
        m.ray_tracer = _Tracer(m.ray_tracer, self.primary, True)
        if m.secondary_ray_tracer is not None:
            m.secondary_ray_tracer = _Tracer(m.secondary_ray_tracer, self.events, False)
        orig = self.pt.sample_direction

        def draw(name, gen, normal, viewdirs, roughness, lgt):
            wi, pdf = orig(name, gen, normal, viewdirs, roughness, lgt)
            self.events.append(("draw", name, wi.detach()))
            return wi, pdf

        self.pt.sample_direction = draw
        return self

    def __exit__(self, *exc):
        m = self.model
        m.ray_tracer, m.secondary_ray_tracer, self.pt.sample_direction = self._saved
        return False

    def take(self):
        """-> (primary, events) recorded so far, and start afresh."""
        out = (self.primary[:], self.events[:])
        self.primary.clear()
        self.events.clear()
        return out
