"""The benchmark is driven by data: every configuration, traffic mix and
metric is a file found by name, a new cell and a new metric are taken up
as new files alone, and BENCHMARK.json keeps the contract's forms."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark.lib import harness
from benchmark.lib.record import Record

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")


@pytest.fixture(scope="module")
def spec():
    return harness.load_json(ROOT / "BENCHMARK.json")


def test_keys_and_forms(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert TEXT.match(w["why"])
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                 "higher")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    names = [x["name"] for x in spec["configs"]] + [x["name"] for x in spec["workloads"]] + \
        [x["name"] for x in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_check_fits_its_time(spec):
    """A full check with the 24 cells a benchmark may grow to fits 43 200 s."""
    runs = 2 + 14 * 24
    assert runs * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_files_found_by_name(spec):
    for w in spec["workloads"]:
        cell, conf, traffic = harness.load_cell(spec, w["name"])
        assert conf["name"] == w["config"] and traffic["name"] == w["traffic"]
        assert (ROOT / "benchmark" / "drivers" / f"{traffic['entry']}.py").exists()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").exists()
    for m in spec["end_to_end"] + spec["per_layer"]:
        reader = harness.load_file_module(ROOT / "benchmark" / "metrics" / f"{m['name']}.py",
                                          "t_" + m["name"].replace(".", "_"))
        assert callable(reader.read)
        assert reader.read(Record("none", "none")) is None or m["name"] == "setup_s"


def test_each_cell_reports_what_it_must(spec):
    for w in spec["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(spec, w["name"], "end_to_end")}
        per = harness.cell_metrics(spec, w["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        for m in per:   # the end-to-end metric it moves is the cell's
            assert m["moves"] in e2e


def test_moves_reported_by_every_cell_that_reports_it(spec):
    for m in spec["per_layer"]:
        e2e = {x["name"]: x for x in spec["end_to_end"]}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_and_metric_are_new_files_alone(tmp_path, spec):
    """A later change adds a traffic mix, a cell, a metric and its reader:
    new files and entries, no file that is there edited."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "benchmark")
    new = json.loads(json.dumps(spec))
    traffic = harness.load_json(ROOT / "benchmark" / "traffic" / "predcls.b16.json")
    traffic = dict(traffic, name="predcls.b32", batch=32)
    (tmp_path / "benchmark" / "traffic" / "predcls.b32.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark" / "limits" / "motifnet-vgg16.predcls.b32.json").write_text(
        (ROOT / "benchmark" / "limits" / "motifnet-vgg16.predcls.b16.json").read_text())
    new["workloads"].append({"name": "motifnet-vgg16.predcls.b32", "config": "motifnet-vgg16",
                             "traffic": "predcls.b32", "chips": 1, "why": "a batch of 32"})
    new["end_to_end"][0]["workloads"].append("motifnet-vgg16.predcls.b32")
    new["per_layer"].append({"name": "batches_read", "unit": "batches", "better": "higher",
                             "source": "program_counter", "layer": "Eval loop",
                             "moves": "infer_imgs_per_s",
                             "workloads": ["motifnet-vgg16.predcls.b32"]})
    (tmp_path / "benchmark" / "metrics" / "batches_read.py").write_text(
        "def read(record):\n    return record.batches or None\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    after = _digest(tmp_path / "benchmark")
    assert all(after[k] == v for k, v in before.items())

    cell, conf, tr = harness.load_cell(new, "motifnet-vgg16.predcls.b32", root=tmp_path)
    assert tr["batch"] == 32 and conf["name"] == "motifnet-vgg16"
    per = harness.cell_metrics(new, "motifnet-vgg16.predcls.b32", "per_layer")
    assert [m["name"] for m in per] == ["batches_read"]
    rec = Record("eval_loop", "motifnet-vgg16.predcls.b32")
    rec.batches = 7
    assert harness.read_metrics(per, rec, root=tmp_path) == {
        "batches_read": {"value": 7.0, "unit": "batches"}}
    e2e = harness.cell_metrics(new, "motifnet-vgg16.predcls.b32", "end_to_end")
    assert [m["name"] for m in e2e] == ["infer_imgs_per_s", "setup_s"]


def test_a_reader_that_finds_nothing_leaves_its_metric_out(spec):
    per = harness.cell_metrics(spec, "motifnet-vgg16.sgdet.b16", "per_layer")
    rec = Record("eval_loop", "motifnet-vgg16.sgdet.b16")
    assert harness.read_metrics(per, rec) == {}
