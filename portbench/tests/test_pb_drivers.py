"""Each traffic driver rehearsed at a tiny size on the CPU (the kernels' plain
versions run there), through the harness's own entry: a sound run is
correct; the control (the reference in a lower precision in the program's
place) and the program with its timed path broken underneath are not."""

import pytest
from portbench import run as R
from portbench.control import control_run
from portbench.faults import FAULTS
from tiny import tiny_run


def _result(cell, **kw):
    result, lines = R.run_cell(tiny_run(cell, **kw))
    assert [ln.split(":")[0] for ln in lines] == ["check " + k for k in result["check"]]
    assert list(result)[-1] == "check"
    return result


@pytest.mark.parametrize("cell", ["nefii.train", "neus.train", "nefii.render256"])
def test_a_sound_run_is_correct(cell):
    r = _result(cell)
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) >= {"setup_s", "peak_mem_gib"}


def test_a_traced_run_reads_its_metrics():
    r = _result("nefii.train", seconds=0.5, trace=True)
    assert r["correct"]
    assert "collate_ms.train" in r["metrics"] and "busy_s" in r["device"]


@pytest.mark.parametrize("cell", ["nefii.train", "nefii.render256"])
def test_the_control_is_not_correct(cell):
    r = control_run(tiny_run(cell))
    assert r["program_correct"], r["program"]
    assert not r["control_correct"], r["control"]


@pytest.mark.parametrize("cell,fault", [
    ("nefii.train", "state_unchanged"), ("nefii.train", "half_batch"),
    ("nefii.train", "radiance_altered"), ("nefii.train", "sdf_altered"),
    ("neus.train", "half_batch"),
    ("nefii.render256", "pixel_altered"), ("nefii.render256", "sdf_altered")])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    with FAULTS[fault]():
        r = _result(cell)
    assert not r["correct"], r["check"]
