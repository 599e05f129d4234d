"""Nothing that run.py or the reference loads has the top-level name jax,
jaxlib, flax or dct_carver_tpu, compared whole (the port's name,
dct_carver_tpu_torch, begins with the JAX package's)."""

import json
import subprocess
import sys

from benchlib.spec import BENCH, ROOT

PROBE = f"""
import json, sys
sys.argv = ["run.py"]
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
import dataclasses, run
from benchlib import spec
from reference import carve
cell = spec.load_cell("photo1080_n8.headline")
cell = dataclasses.replace(cell, config=dict(cell.config, height=24, width=36),
                           traffic=dict(cell.traffic, remove={{"width": 2}}))
result, _ = run.run(cell, 3, 0.05, False, device="cpu",
                    placement={{"device": "cpu"}})
print(json.dumps({{"correct": result["correct"],
                  "forbidden": run.forbidden_modules(),
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_no_jax_in_a_run():
    p = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                       text=True, cwd=ROOT, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["forbidden"] == []
    assert "dct_carver_tpu_torch" in out["top"]
    assert not {"jax", "jaxlib", "flax", "dct_carver_tpu"} & set(out["top"])


def test_the_check_compares_whole_names(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "dct_carver_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert run.forbidden_modules() == ["jaxlib"]


def test_no_card_no_result():
    p = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "photo1080_n8.headline", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT),
                          "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "CUDA card" in p.stderr


def test_no_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "photo1080_n8.headline", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and not p.stdout.strip()
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())
