"""mfu.train / mfu.render: the least seconds the chip needs for the
stretch's work at the peaks of the precisions the configuration declares
(the trace's SDF evaluations in fused_sdf_dtype, the rest in FP32), over
the stretch's wall time, in percent. The work is what the reference counts
for the steps it followed (rays, hits, its own trace's evaluations a ray),
times the stretch's iterations and distillation iterations, or chunks."""
from portbench.metrics._common import per


def read(reading, suffix):
    n = per(reading, suffix)
    if n is None:
        return None
    w, t = reading["work"], reading["timeline"]
    if suffix == "train":
        d = reading["distils"]
        if d and w["distil_iter_s"] is None:
            return None
        need = (n - d) * w["iter_s"] + d * (w["distil_iter_s"] or 0.0)
    else:
        need = n * w["chunk_s"]
    return 100.0 * need / t.wall_s
