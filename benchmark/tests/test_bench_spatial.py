"""The spatial cell, `pano8k_n8.spatial`: it loads as BASELINE config 5 on
four shards of one card; a run at a small size on the CPU (four CPU
shards) is `correct` and loads no JAX, and sees a seam step that leaves
its state unchanged; the control fails its limits on that run's inputs;
and its three per-layer readers (`spatial_dp_roofline`,
`sharded_apply_roofline`, `step_setup_ms_per_request`) read synthetic
traces as their docstrings say."""

import dataclasses
import json
import subprocess
import sys

import pytest

from benchlib import spec
from benchlib import trace as tr
from benchlib.reading import TracedRun
from benchlib.spec import BENCH, ROOT

CELL = "pano8k_n8.spatial"
SMALL = {"height": 40, "width": 256}
REMOVE = {"remove": {"width": 8}}
NEW = ("spatial_dp_roofline", "sharded_apply_roofline",
       "step_setup_ms_per_request")


def _small():
    cell = spec.load_cell(CELL)
    return dataclasses.replace(cell, config={**cell.config, **SMALL},
                               traffic={**cell.traffic, **REMOVE})


def _metric(name):
    return spec.load_module("metrics", name)


def test_the_spatial_cell_loads_as_config_5_on_one_card():
    c = spec.load_cell(CELL)
    assert c.chips == 1 and c.entry.__name__.endswith("carve_spatial")
    assert (c.config["height"], c.config["width"]) == (4320, 7680)
    assert c.config["knobs"]["blocksize"] == 8
    assert c.config["reduced"] == ["hosts"] and c.config["hosts"] == 1
    shards = c.traffic["shards"]
    assert shards == 4 and c.config["width"] % shards == 0
    assert -(-c.config["height"] // 96) == 45  # K-row blocks a seam
    assert {m["name"] for m in c.end_to_end} == {
        "mpix_s", "peak_mib_per_image", "setup_s"}
    assert set(NEW) <= {m["name"] for m in c.per_layer}
    assert c.entry.images_per_card(c.config, c.traffic, 1) == {0: 1}


PROBE = f"""
import json, sys
sys.argv = ["run.py"]
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
import dataclasses, run
from benchlib import spec
cell = spec.load_cell({CELL!r})
cell = dataclasses.replace(cell, config=dict(cell.config, **{SMALL!r}),
                           traffic=dict(cell.traffic, **{REMOVE!r}))
result, _ = run.run(cell, 2**31 + 21, 0.05, False, device="cpu",
                    placement={{"device": "cpu"}})
print(json.dumps({{"correct": result["correct"],
                  "checks": result["checks"],
                  "metrics": sorted(result["metrics"]),
                  "forbidden": run.forbidden_modules(),
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_a_small_run_on_four_cpu_shards_is_correct_without_jax():
    p = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                       text=True, cwd=ROOT, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["metrics"] == ["mpix_s", "setup_s"]  # no card: no peak
    assert out["forbidden"] == []
    assert "dct_carver_tpu_torch" in out["top"]
    assert not {"jax", "jaxlib", "flax", "dct_carver_tpu"} & set(out["top"])


def test_a_seam_step_that_changes_nothing_is_not_correct(monkeypatch):
    import run
    from dct_carver_tpu_torch.parallel import spatial

    def step(self, src):  # the planes stay as they were; the widths move
        for dst, x in zip(self.sets[1 - src], self.sets[src]):
            if x is not None:
                for d, s in zip(dst, x):
                    d.copy_(s)
        for w, nw in zip(self.width, self.new_width):
            w.sub_(1)
            nw.sub_(1)

    monkeypatch.setattr(spatial._SeamSteps, "_step", step)
    result, _ = run.run(_small(), 2**31 + 22, 0.05, False, device="cpu",
                        placement={"device": "cpu"})
    assert result["failed"] == 0 and result["correct"] is False
    assert any(v["value"] > v["limit"] for v in result["checks"].values())


def test_the_control_fails_its_limits_on_a_small_run():
    import control

    out = control.control(_small(), 2**31 + 21, device="cpu")
    assert out["correct"] is False
    assert out["checks"]["vmap_diff"]["value"] > 0


def _op(name, a, b):
    return tr.DeviceOp(name, a, b, 0, "kernel")


def _run(ops, work=None, spans=(), requests=((0.0, 100.0),)):
    host = [tr.HostSpan(n, a, b) for n, a, b in spans]
    host += [tr.HostSpan(tr.REQUEST, a, b) for a, b in requests]
    trace = tr.Trace(sorted(ops, key=lambda o: o.start),
                     sorted(host, key=lambda h: h.start), list(requests))
    return TracedRun(trace, [0], {}, len(requests), 1, work or {})


def test_the_spatial_rooflines_are_least_time_over_their_kernels_time():
    from benchlib import peaks

    least = (peaks.HBM_BYTES_PER_S * 1e-6, 0)  # 1 us at the memory's peak
    ops = [_op("void dct_carver::block_dp_parts_kernel<4>(float const*)",
               0, 2),
           _op("void dct_carver::block_dp_kernel<4>(float const*)", 2, 3),
           _op("dct_carver::seg_walk_kernel(float const*)", 3, 4),
           _op("dct_carver::sharded_apply_kernel(float*)", 4, 9),
           _op("dct_carver::apply_kernel(float*)", 9, 29),
           _op("void dct_carver::tile_rows_kernel<4, true, false>", 29, 49)]
    run = _run(ops, {"find_seam": least, "apply": least})
    # 1 us least over 4 us of the block DPs and the walk; over 5 us of
    # the sharded apply: neither reads the single-image route's kernels
    assert _metric("spatial_dp_roofline").read(run) == pytest.approx(25.0)
    assert _metric("sharded_apply_roofline").read(run) == pytest.approx(20.0)
    # the single-image route's readers do not read the spatial kernels
    assert _metric("apply_roofline").read(run) == pytest.approx(5.0)
    assert _metric("find_seam_roofline").read(run) == pytest.approx(5.0)
    # no spatial kernel in the trace, or no count: nothing read
    plain = _run(ops[4:], {"find_seam": least, "apply": least})
    assert _metric("spatial_dp_roofline").read(plain) is None
    assert _metric("sharded_apply_roofline").read(plain) is None
    assert _metric("spatial_dp_roofline").read(_run(ops)) is None


def test_the_spatial_kernels_are_held_to_their_credited_launches():
    mods = {n: _metric(n) for n in NEW[:2]}
    ops = [_op("block_dp_parts_kernel<4>", 0, 1),
           _op("seg_walk_kernel", 1, 2),
           _op("sharded_apply_kernel", 2, 3)]
    credited = {"block_dp_parts": 1, "seg_walk": 1, "sharded_apply": 1,
                "block_dp": 0}
    assert tr.count_check(_run(ops).trace, credited, mods) == (True, 3, 3)
    assert tr.count_check(_run(ops[1:]).trace, credited, mods) == (
        False, 2, 3)


def test_step_setup_reads_as_its_batch_twin_and_moves_mpix_s():
    base = _metric("step_setup_ms_per_request")
    twin = _metric("step_setup_ms_per_request.batch")
    # the build 5-10, the eager seam 10-30 and the capture 25-40: 35 us;
    # the seam loop's own span and the record are no set-up; two requests
    run = _run([_op("k", 0, 200)],
               spans=[("carve.steps.build", 5, 10),
                      ("carve.seam.eager", 10, 30), ("carve.capture", 25, 40),
                      ("carve.seams", 10, 90),
                      ("carve.spatial.record", 85, 90)],
               requests=((0.0, 100.0), (100.0, 200.0)))
    assert base.read(run) == twin.read(run) == pytest.approx(35e-3 / 2)
    assert (base.LAYER, base.UNIT, base.SOURCE, base.SPANS) == (
        twin.LAYER, twin.UNIT, twin.SOURCE, twin.SPANS)
    assert (base.MOVES, twin.MOVES) == ("mpix_s", "carve_ms_min")
    # a program without the spans (the parent of the spatial route's)
    assert base.read(_run([_op("k", 0, 50)],
                          spans=[("aten::copy_", 0, 40)])) is None
