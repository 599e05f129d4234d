"""Every configuration, traffic, entry and metric file loads and is found by
name; BENCHMARK.json keeps the contract's shape; a cell, traffic or metric
added as new files is found without editing any file."""

import json
import re
import shutil

import pytest

from benchlib import spec
from benchlib import traffic as tf

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = spec.load_cell(cell)
    assert c.chips in (1, 4)
    assert callable(c.entry.make_call) and callable(c.entry.reference)
    assert tf.passes(c.config, c.traffic)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for name, mod in spec.metric_modules(c).items():
        assert callable(mod.read)


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_metric_file_matches_benchmark(metric):
    mod = spec.load_module("metrics", metric["name"])
    assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
        metric["layer"], metric["unit"], metric["moves"], metric["source"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    moved = e2e[metric["moves"]]
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
        assert "workloads" not in moved or cell in moved["workloads"]


def test_benchmark_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert (spec.ROOT / p).is_dir() and not p.endswith("_torch")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert json.loads((spec.ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"]
    fours = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


def test_added_files_are_found_without_edits(tmp_path):
    """A new traffic mix, cell and per-layer metric: files added, and
    entries appended to BENCHMARK.json, nothing under benchmark/ edited."""
    bench = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p.relative_to(bench): p.read_bytes()
              for p in bench.rglob("*") if p.is_file()}
    data = json.loads(json.dumps(BENCH))
    (bench / "traffic" / "reduce10.json").write_text(json.dumps(
        {"entry": "carve", "remove": {"width_share": 0.1}, "pool": 2,
         "sample": 2, "trace_requests": 2}))
    (bench / "metrics" / "requests_traced.py").write_text(
        'LAYER = "device"\nUNIT = "requests"\nMOVES = "mpix_s"\n'
        'SOURCE = "program_counter"\n\n\ndef read(run):\n'
        '    return run.requests\n')
    data["workloads"].append({"name": "photo1080_n8.reduce10",
                              "config": "photo1080_n8",
                              "traffic": "reduce10", "chips": 1,
                              "why": "a test's cell"})
    data["per_layer"].append({"name": "requests_traced", "unit": "requests",
                              "better": "higher", "source": "program_counter",
                              "layer": "device", "moves": "mpix_s",
                              "workloads": ["photo1080_n8.reduce10"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    c = spec.load_cell("photo1080_n8.reduce10", root=tmp_path, bench=bench)
    assert tf.removal(c.config, c.traffic) == (192, 0)
    assert list(spec.metric_modules(c, bench)) == ["requests_traced"]
    for rel, body in before.items():
        assert (bench / rel).read_bytes() == body
