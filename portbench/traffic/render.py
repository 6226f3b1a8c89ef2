"""Novel-view rendering as `RenderRunner.render_view` renders a view, in a
closed loop over chunks: each chunk is `utils.split_input`'s slice of a
view's multi-ray input, `pixels_per_chunk(memory_capacity_level, num_rays)`
pixels, rendered by `spmd.eval_forward(model, batch, gen, OUTPUT_KEYS)` and
fetched to the host. The chunks of all views are visited in a seeded
shuffled order, cycling, each view drawing from its own generator as
render_view seeds it.

Parameters: n_views, res (the rendered views), num_rays,
memory_capacity_level, gamma, fit_steps, fit_batch, check_chunks (chunk
ordinals of the window the reference follows), trace_chunks (chunks in the
traced stretch).
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.profiler import record_function

from portbench import check, core, flops, harness, scene, tracing
from portbench.record import Recorder
from portbench.reference import pipeline as R

WARMUP_CHUNKS = 2  # chunks rendered in set-up, before the window


def chunk_order(counts, seed: int):
    """Every chunk of every view once, the views in turn, each view's
    chunks from a seeded offset at a stride near the golden section of its
    count (odd, so coprime with a power of two): any stretch of the order
    then samples each view's rows about evenly, object and background as
    the whole view does, whatever the seed."""
    rng = np.random.default_rng(seed % (1 << 63))
    per_view = []
    for n in counts:
        stride = max(1, int(n * 0.381966)) | 1
        while np.gcd(stride, n) != 1:
            stride += 2
        off = int(rng.integers(n))
        per_view.append([(off + k * stride) % n for k in range(n)])
    return [(v, per_view[v][k]) for k in range(max(counts)) for v in range(len(counts))
            if k < counts[v]]


def run(run: core.Run) -> core.Outcome:
    from nefii_tpu_torch.config import get_class
    from nefii_tpu_torch.ops import path_tracing as ptr
    from nefii_tpu_torch.ops.kernels import fused_mlp
    from nefii_tpu_torch.parallel import spmd
    from nefii_tpu_torch.scripts.render import OUTPUT_KEYS
    from nefii_tpu_torch.utils import general as utils

    p = {**run.cell.params, **(run.tiny or {}).get("params", {})}
    phase = harness.Phases(run.t0)
    phase("imports")
    dev = torch.device(run.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work_dir = harness.workdir(run.cell.name)
    s_scene, s_weights, s_check, s_order = harness.seeds(run.seed, 4)
    conf = harness.conf(run)
    cm = conf.get_config("model").as_plain_dict()

    # ---- set-up -------------------------------------------------------------------
    data = os.path.join(work_dir, "views")
    cams = scene.ring_cameras(p["n_views"], p["res"], phase=0.5)
    light = scene.seeded_light(harness.generator(dev, s_scene), 8, dev)
    scene.write_split(data, cams, p["res"], light, dev)
    phase("scene")
    P, fit_err = harness.make_weights(cm, s_weights, p, dev)
    phase(f"weights (the SDF fit's L1 {fit_err:.5f})")
    ds = get_class(conf.get_string("train.dataset_class"))(p["gamma"], data, False, 1)
    model = get_class(conf.get_string("train.model_class")).from_conf(
        conf.get_config("model"), device=dev)
    model.eval()
    harness.load_into(model, P)
    if model.secondary_ray_tracer is None:
        raise ValueError("the check follows a conf with a secondary_ray_tracer block")

    n_pix = max(min(utils.pixels_per_chunk(p["memory_capacity_level"], p["num_rays"]),
                    ds.total_pixels), 1)
    views = []
    for i in range(len(ds)):
        ds.sampling_idx = None
        ds.change_sampling_rays(p["num_rays"] if p["num_rays"] > 1 else -1,
                                np.random.default_rng(i))
        idx, mi, gt = ds[i]
        _, mi, _ = ds.collate([(idx, mi, gt)])
        ds.change_sampling_rays(-1)
        views.append(utils.split_input(mi, ds.total_pixels, n_pix))
    gens = [torch.Generator(device=dev).manual_seed(spmd.rank_seed(i, 0)) for i in range(len(ds))]
    order = chunk_order([len(v) for v in views], s_order)
    P = harness.moved(P, torch.device("cpu"))
    phase("model and views")

    def chunk_batch(ch):
        return {
            "uv": torch.as_tensor(np.asarray(ch["uv"], np.float32), device=dev),
            "object_mask": torch.as_tensor(np.asarray(ch["object_mask"]), device=dev),
            "intrinsics": torch.as_tensor(np.asarray(ch["intrinsics"], np.float32), device=dev),
            "pose": torch.as_tensor(np.asarray(ch["pose"], np.float32), device=dev),
        }

    cursor = [0]

    def render_chunk():
        v, c = order[cursor[0] % len(order)]
        cursor[0] += 1
        ch = dict(views[v][c])
        ch.pop("__valid__")
        batch = chunk_batch(ch)
        out = spmd.eval_forward(model, batch, gens[v], OUTPUT_KEYS)
        with record_function("portbench.fetch"):
            host = {k: out[k].cpu().numpy() for k in OUTPUT_KEYS}
        return batch, host

    with torch.no_grad():
        for _ in range(WARMUP_CHUNKS):
            render_chunk()
        phase("warm-up chunks")

        # ---- the window --------------------------------------------------------------
        harness.sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t_w = harness.clock()
        setup_s = t_w - run.t0
        n_chunks, followed, timeline, rows, st_chunks = 0, [], None, None, 0
        check_at = set(p["check_chunks"])
        rec = Recorder(model, ptr)
        while harness.clock() - t_w < run.seconds or n_chunks <= max(check_at) \
                or (run.trace and timeline is None):
            if run.trace and timeline is None and n_chunks > max(check_at) \
                    and harness.clock() - t_w > 0.1 * run.seconds:
                stretch = tracing.Stretch(os.path.join(work_dir, "trace.json"))
                with flops.KernelRows(fused_mlp) as rows:
                    stretch.start(lambda: harness.sync(dev))
                    for _ in range(p["trace_chunks"]):
                        render_chunk()
                    timeline = stretch.stop(lambda: harness.sync(dev))
                st_chunks = p["trace_chunks"]
                n_chunks += st_chunks
                continue
            if n_chunks in check_at:
                with rec:
                    batch, host = render_chunk()
                prim, events = rec.take()
                followed.append(harness.moved(dict(batch=batch, primary=prim[0], events=events,
                                                   outputs=host), torch.device("cpu")))
            else:
                render_chunk()
            n_chunks += 1
        window_s = harness.clock() - t_w
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    out = core.Outcome(attempted=n_chunks, failed=0, memory_peak_bytes=peak)
    out.e2e = {"render_px_per_s": n_chunks * n_pix / window_s, "peak_mem_gib": peak / 2 ** 30,
               "setup_s": setup_s}
    del model, views, gens
    harness.release()
    ref_model = R.Model(cm)
    followed, P = harness.moved(followed, dev), harness.moved(P, dev)

    def numbers_for(control):
        return check.check_render(ref_model, conf.as_plain_dict(), P, followed, run.cell.limits,
                                  gen=torch.Generator().manual_seed(s_check), control=control)

    out.numbers, work = numbers_for(None)
    if run.control is not None:
        out.program_numbers, out.numbers = out.numbers, numbers_for(run.control)[0]
    if run.trace:
        out.busy_s, out.window_s = timeline.busy_s(), timeline.wall_s
        out.breakdown = timeline.breakdown()
        out.reading = dict(kind="render", timeline=timeline, chunks=st_chunks, rows=rows,
                           shapes=ref_model.sdf.shapes, work=work, pixels=n_pix)
    del followed
    harness.release()
    return out
