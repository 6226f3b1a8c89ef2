"""The port's spans and host-sync counters (utils/telemetry.py) on the CPU:
the counts by site, the spans recorded only under a profiler, as many
`host_sync.*` spans in a profiled trace as the counters add, StepProfiler's
summary of a trace. The counts in `step_stats` and `RenderRunner.stats` are
checked by the training and render CLI tests."""

import json

import torch

from nefii_tpu_torch.ops.ray_tracing import RayTracer
from nefii_tpu_torch.training import trainer
from nefii_tpu_torch.utils import telemetry


def test_host_sync_counts_by_site():
    before = telemetry.sync_counts()
    for site in ("test.a", "test.b", "test.a"):
        with telemetry.host_sync(site):
            pass
    after = telemetry.sync_counts()
    assert after["test.a"] - before.get("test.a", 0) == 2
    assert after["test.b"] - before.get("test.b", 0) == 1
    assert telemetry.sync_total() == sum(after.values())
    after["test.a"] = -1  # a copy
    assert telemetry.sync_counts()["test.a"] >= 2


def test_spans_record_only_under_a_profiler(tmp_path):
    """No profiler: the shared no-op context, nothing recorded; under
    torch.profiler on the CPU both are user annotations in the trace."""
    assert telemetry.span("outer") is telemetry.host_sync("test.idle")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with telemetry.span("outer"):
            with telemetry.host_sync("test.traced"):
                torch.ones(4).sum()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    marks = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(marks) == ["host_sync.test.traced", "outer"]
    assert telemetry.span("outer") is telemetry.span("inner")


def test_a_traced_ray_trace_marks_every_counted_sync():
    """A RayTracer on an analytic sphere under the profiler: one
    `host_sync.<site>` span for each sync the counters add, site by site."""
    g = torch.Generator().manual_seed(0)
    dirs = torch.nn.functional.normalize(
        torch.randn(1, 64, 3, generator=g) * 0.2 + torch.tensor([0.0, 0.0, 1.0]), dim=-1)
    cam = torch.tensor([[0.0, 0.0, -2.0]])
    mask = torch.ones(64, dtype=torch.bool)
    before = telemetry.sync_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = RayTracer(n_steps=16)(lambda p: p.norm(dim=-1) - 0.5, cam, mask, dirs,
                                     training=True, gen=g)
    after = telemetry.sync_counts()
    assert out.object_mask.any()
    delta = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    spans = {}
    for e in prof.events():
        if e.name.startswith(telemetry.SYNC_PREFIX):
            site = e.name[len(telemetry.SYNC_PREFIX):]
            spans[site] = spans.get(site, 0) + 1
    assert spans == delta and delta["tracer.live_any"] > 0 and delta["tracer.gather"] > 0


def test_profile_summary_reads_device_work_by_category():
    """Two steps of hand-made events: spans (any name, host_sync.* too) are
    never kernels, busy time is the union of the device's operations, and
    the idle after a sync counts each gap that holds a sync's host end once."""
    ev = [{"cat": "user_annotation", "name": f"ProfilerStep#{i}", "ts": 100 * i, "dur": 100}
          for i in (0, 1)]
    ev += [{"cat": "kernel", "name": "k", "ts": a, "dur": d}
           for a, d in ((0, 30), (10, 10), (50, 10), (120, 40))]
    ev += [{"cat": "gpu_memcpy", "name": "copy", "ts": 180, "dur": 20}]
    ev += [{"cat": "user_annotation", "name": "host_sync.tracer.gather", "ts": t, "dur": 1}
           for t in (33, 40, 100, 165)]
    ev += [{"cat": "user_annotation", "name": "primary_trace", "ts": 0, "dur": 150},
           {"cat": "gpu_user_annotation", "name": "primary_trace", "ts": 0, "dur": 160}]
    lines = trainer.profile_summary(ev, on_device=True)
    # busy 30 + 10 + 40 + 20 = 100 us of 200: idle 50%; the gaps 30-50 (two
    # sync ends) and 60-120 (one) follow a sync, 160-180 (one) too: 100 us
    assert lines[0] == ("2 steps: 0.000 s wall a step, device busy 0.000 s a step, "
                        "idle 50.0%, idle after a host sync 50.0%")
    assert lines[1] == "host syncs: 2 a step"
    assert lines[2] == "host sync tracer.gather: 2 a step"
    assert lines[3].startswith("span primary_trace: 0.5 calls")
    assert [ln.split(":")[0] for ln in lines[4:]] == ["kernel k", "kernel copy"]
    assert lines[4].startswith("kernel k: 2 launches")


def test_idle_after_syncs_counts_a_gap_once():
    busy = [[0, 10], [20, 30], [50, 60], [80, 90]]
    assert trainer.idle_after_syncs(busy, [15, 40, 45, 25]) == 30
    assert trainer.idle_after_syncs(busy, []) == 0
    assert trainer.idle_after_syncs(busy, [60, 95]) == 20
