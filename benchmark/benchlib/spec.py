"""Find a cell's parts by name: its workload entry in `BENCHMARK.json`, its
configuration (`configs/<config>.json`), its traffic (`traffic/<traffic>
.json`), the entry point the traffic drives (`entries/<entry>.py`) and the
per-layer metrics (`metrics/<metric>.py`).  Adding any of them is adding a
file; nothing here lists them."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

__all__ = ["BENCH", "ROOT", "Cell", "load_benchmark", "load_cell",
           "load_module", "metric_modules"]

BENCH = Path(__file__).resolve().parents[1]  # the benchmark's folder
ROOT = BENCH.parent                           # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict     # configs/<config>.json
    traffic: dict    # traffic/<traffic>.json
    entry: ModuleType
    end_to_end: list  # the BENCHMARK.json metrics this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_module(kind: str, name: str, bench: Path = BENCH) -> ModuleType:
    """`<bench>/<kind>/<name>.py` as a module of its own."""
    path = bench / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {path.relative_to(bench.parent)}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = ROOT, bench: Path = BENCH) -> Cell:
    spec = load_benchmark(root)
    w = _named(spec["workloads"], name, "workload")
    cfg_entry = _named(spec["configs"], w["config"], "configuration")
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        entry=load_module("entries", traffic["entry"], bench),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


def metric_modules(cell: Cell, bench: Path = BENCH) -> dict:
    return {m["name"]: load_module("metrics", m["name"], bench)
            for m in cell.per_layer}
