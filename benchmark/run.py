#!/usr/bin/env python3
"""Run one cell of the benchmark once, in this process, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell is a `workloads` entry of
`BENCHMARK.json`; its configuration, traffic, entry point and per-layer
metrics are files under this folder, found by name (`benchlib/spec.py`).

1. Set-up: the program's kernels load (built into `build/` of the checkout
   on a cell's first run), the inputs are made from the seed, and one
   request of the cell's own shape runs, which captures its seam-step
   graphs.
2. The window: a closed loop of whole requests for `--seconds` (with
   `--trace 1`, the traffic's `trace_requests` requests under
   `torch.profiler`).
3. The check: a sample of the requests, drawn from the seed, against the
   plain reference (`reference/carve.py`), after the program's state is
   freed.

The last line of standard output is the result: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer ones), `device`, `breakdown` when traced, and `checks`, the
numbers compared with their limits, which are also the last lines of
standard error.  With no card, fewer cards than the cell asks for, or
JAX loaded when the window has closed, it prints no result and exits
with another code than 0.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / "build" / "bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")

from benchlib import spec, stats  # noqa: E402
from benchlib import trace as tr  # noqa: E402
from benchlib import traffic as tf  # noqa: E402
from benchlib.check import Checks  # noqa: E402
from benchlib.reading import TracedRun  # noqa: E402
from benchlib.work import pass_work  # noqa: E402

# whole top-level module names that may not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "dct_carver_tpu")
TRACE_ATTEMPTS = 3  # a trace that lost launches is taken again


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(cards) -> None:
    import torch

    for d in cards:
        torch.cuda.synchronize(d)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def reference(entry, cfg: dict, traffic: dict, pool: list, need: list,
              picks: list, device, dtype=None) -> dict:
    """{pool index: (images, [vmaps])}: the reference's outputs for the
    `picks` images of each needed pool input, in one run over them all."""
    import numpy as np
    import torch

    if not need:
        return {}
    stack = np.concatenate([pool[p][picks] for p in need])
    images, vmaps = entry.reference(stack, cfg, traffic, device,
                                    dtype or torch.float32)
    n = len(picks)
    return {p: (images[i * n:(i + 1) * n],
                [v[i * n:(i + 1) * n] for v in vmaps])
            for i, p in enumerate(need)}


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda:0", placement: dict | None = None,
        cards: int | None = None) -> tuple[dict, list]:
    """Set up, measure and check `cell` once; (result, check lines).
    `device`: where the benchmark makes its inputs and runs the
    reference.  `placement`: keywords that the entry passes the program
    (none on the card: the program's own default placement).  `cards`: the
    cards the program uses (default: every visible card for an entry that
    spreads over them, else 1)."""
    import torch

    from dct_carver_tpu_torch.kernels import launch_counts
    from dct_carver_tpu_torch.ops.carve import clear_step_cache

    cfg, traffic, entry = cell.config, cell.traffic, cell.entry
    placement = placement or {}
    if cards is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 1
    per_card = entry.images_per_card(cfg, traffic, cards)
    devices = ([torch.device("cuda", c) for c in per_card]
               if torch.device(device).type == "cuda" else [])
    passes = tf.passes(cfg, traffic)
    B = int(traffic.get("batch", 1))

    pool = tf.make_pool(seed, cfg, traffic, device)
    if devices:
        torch.cuda.empty_cache()
    call = entry.make_call(cfg, traffic, placement)
    call(pool[0])  # warm: the cell's shapes, its graphs captured
    _sync(devices)
    picks = tf.sample_images(seed, B, len(per_card),
                             traffic.get("sample_images"))
    reservoir = tf.Reservoir(int(traffic["sample"]), seed)
    kept = [None] * reservoir.size      # (pool index, images, vmaps)
    traced_vmaps = {}                   # pool index -> vmaps, traced runs

    def keep(k, out):
        images, vmaps = out
        p = k % len(pool)
        if trace and p not in traced_vmaps:
            traced_vmaps[p] = vmaps
        slot = reservoir.slot()
        if slot is not None:
            sel = (lambda a: a) if len(picks) == B else (
                lambda a: None if a is None else a[picks])
            kept[slot] = (p, sel(images), [sel(v) for v in vmaps])

    for d in devices:
        torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - T0
    launches0 = launch_counts()
    traced = None
    if not trace:
        deadline = time.perf_counter() + seconds
        log, failed, err = tf.closed_loop(
            call, pool, lambda k, now: k > 0 and now >= deadline, keep,
            lambda name: contextlib.nullcontext())
        _sync(devices)
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        n = int(traffic["trace_requests"])
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if devices else [])
        for attempt in range(TRACE_ATTEMPTS):
            launches0 = launch_counts()
            with profile(activities=acts) as prof:
                log, failed, err = tf.closed_loop(
                    call, pool, lambda k, now: k >= n, keep, record_function)
                _sync(devices)
            traced = tr.collect(prof)
            if failed or not devices:
                break
            delta = {k: v - launches0[k] for k, v in launch_counts().items()}
            ok, seen, credited = tr.count_check(
                traced, delta, spec.metric_modules(cell))
            print(f"trace {attempt + 1}: {seen} of the program's kernels "
                  f"seen, {credited} credited", file=sys.stderr)
            if ok:
                break
        else:
            raise RuntimeError(
                f"{TRACE_ATTEMPTS} traces held fewer kernels than the "
                f"launches credited: not read")
    launches = {k: v - launches0[k] for k, v in launch_counts().items()}
    if failed:
        print(err, file=sys.stderr)
    if log:
        q = [log[i * len(log) // 4:(i + 1) * len(log) // 4] for i in range(4)]
        print(f"set-up {setup_s:.3f} s; {len(log)} requests in "
              f"{log[-1][1] - log[0][0]:.3f} s; mean ms by quarter: "
              + " ".join(f"{1e3 * sum(b - a for a, b in x) / len(x):.3f}"
                         for x in q if x), file=sys.stderr)
        print("request ms: " + " ".join(
            f"p{p} {stats.percentile_ms(log, p)!r}"
            for p in (0, 25, 50, 75, 100)), file=sys.stderr)

    peaks = {d.index: torch.cuda.max_memory_allocated(d) for d in devices}
    result = {"correct": False, "attempted": len(log) + failed,
              "failed": failed, "metrics": {}}
    if log and not trace:
        e2e = {
            "mpix_s": (stats.mpix_s(log, [tf.work_mpix(cfg, traffic)]
                                    * len(log)), "Mpix/s"),
            "carve_ms_p95": (stats.percentile_ms(log, 95), "ms"),
            "carve_ms_min": (stats.percentile_ms(log, 0), "ms"),
            "peak_mib_per_image": (
                max(peaks[c] / per_card[c] for c in peaks) / 2**20
                if peaks else None, "MiB"),
            "setup_s": (setup_s, "s"),
        }
        for m in cell.end_to_end:
            value, unit = e2e[m["name"]]
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": unit}

    # the program's state goes before the reference runs
    clear_step_cache()
    if devices:
        torch.cuda.empty_cache()
    checks = Checks()
    need = sorted({s[0] for s in kept if s is not None} | set(traced_vmaps))
    t_ref = time.perf_counter()
    refs = reference(entry, cfg, traffic, pool, need, picks, device)
    print(f"reference: {len(need) * len(picks)} images in "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    for s in kept:
        if s is not None:
            p, images, vmaps = s
            want_images, want_vmaps = refs[p]
            checks.add(images, want_images, vmaps, want_vmaps)
    result["correct"] = checks.correct() and not failed

    if trace and traced is not None and log and devices:
        # each pass's least work, once a pool input, counted a request
        work, count = {}, {}
        for k in range(len(log)):
            count[k % len(pool)] = count.get(k % len(pool), 0) + 1
        complete = True
        for p, reps in count.items():
            for i, ps in enumerate(passes):
                vm = traced_vmaps[p][i]
                if vm is None and len(picks) == B:
                    vm = refs[p][1][i]
                if vm is None:
                    complete = False
                    continue
                w = pass_work(vm, ps.seams, cfg["knobs"]["blocksize"],
                              device=device)
                for kind, (nb, ops) in w.items():
                    b0, o0 = work.get(kind, (0, 0))
                    work[kind] = (b0 + reps * nb, o0 + reps * ops)
        if not complete:  # a pass whose seams no output gave: not counted
            work = {k: v for k, v in work.items() if k in ("energy",
                                                         "find_seam")}
        reading = TracedRun(
            trace=traced, devices=[d.index for d in devices],
            launches=launches, requests=len(log),
            seams=len(log) * sum(ps.B * ps.seams for ps in passes),
            work=work, log=log,
            work_mpix=len(log) * tf.work_mpix(cfg, traffic))
        for name, mod in spec.metric_modules(cell).items():
            value = mod.read(reading)
            if value is not None:
                result["metrics"][name] = {"value": value, "unit": mod.UNIT}
        w0, w1 = traced.window
        busy = tr.busy_per_device(traced, reading.devices)
        result["breakdown"] = tr.breakdown(traced, reading.devices)
        trace_device = {"busy_s": sum(busy.values()) / len(busy) / 1e6,
                        "window_s": (w1 - w0) / 1e6}
    else:
        trace_device = {}

    result["device"] = {
        "platform": "gpu" if devices else "cpu",
        "kind": (torch.cuda.get_device_name(devices[0]) if devices
                 else "cpu"),
        "count": len(devices) or 1,
        "memory_peak_bytes": max(peaks.values()) if peaks else 0,
        **trace_device,
        "power": power_limit() if devices else "none",
    }
    result["checks"] = checks.report()
    return result, checks.lines()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible: no result",
              file=sys.stderr)
        return 2
    result, lines = run(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the process that measured: {', '.join(bad)}: "
              f"no result", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
