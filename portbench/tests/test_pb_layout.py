"""The benchmark's files resolve by the names BENCHMARK.json gives them, and
a cell and a metric added as new files are found with no edit."""

import json
import os
import re
import shutil

import pytest

from portbench import core

BENCH = core.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_resolves():
    for w in BENCH["workloads"]:
        cell = core.cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic == w["traffic"] and cell.chips == w["chips"]
        core.driver(cell.traffic)
        assert cell.limits, w["name"]


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_resolves(cfg):
    c = core.load_json(os.path.join(core.ROOT, cfg["file"]))
    assert c["name"] == cfg["name"] and c["reduced"] == cfg["reduced"]
    assert os.path.exists(os.path.join(core.ROOT, c["conf"]))
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    read, suffix = core.reader(m["name"])
    assert callable(read)
    assert read(None, suffix) is None
    e2e = {x["name"] for x in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for w in m["workloads"]:
        reports = [x["name"] for x in BENCH["end_to_end"]
                   if w in x.get("workloads", [w])]
        assert m["moves"] in reports, (m["name"], w)


def test_names_and_units():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_new_cell_and_metric_are_found_as_new_files(tmp_path):
    here = tmp_path / "portbench"
    shutil.copytree(core.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    (here / "workloads" / "neus.render256.json").write_text(json.dumps(
        {"config": "neus-8x256", "traffic": "render", "chips": 1, "why": "x",
         "params": {"n_views": 1}, "limits": {"shade_gap": 1.0}}))
    (here / "metrics" / "hits_share.py").write_text(
        "def read(reading, suffix):\n    return 42.0 if suffix == 'render' else None\n")
    cell = core.cell("neus.render256", here=str(here))
    assert cell.config["name"] == "neus-8x256" and cell.traffic == "render"
    read, suffix = core.reader("hits_share.render", here=str(here))
    assert suffix == "render" and read({}, suffix) == 42.0
