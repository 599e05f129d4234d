#!/usr/bin/env python3
"""The comparison's control: the plain reference one precision lower
(bfloat16 for the configuration's float32) put in the program's place, on
a cell's own inputs at its own size, judged by the same comparison as a
run.  Its numbers are the upper readings of the limits (PERF.md).

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed <m> ...]

Prints one JSON line a seed: the numbers compared and whether the
comparison took the control for correct (it must not).  The benchmark's
own runs never run it."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from benchlib import spec  # noqa: E402
from benchlib import traffic as tf  # noqa: E402
from benchlib.check import Checks  # noqa: E402


def control(cell: spec.Cell, seed: int, device="cuda:0") -> dict:
    """The control's readings on `seed`: the first `sample` inputs of the
    pool (as many as a run compares, the images of each card's chunk as
    the cell's cards cut it), the float32 reference against the bfloat16
    one.  One card serves: the control does not run the program."""
    import torch

    from run import reference

    cfg, traffic, entry = cell.config, cell.traffic, cell.entry
    cards = cell.chips
    B = int(traffic.get("batch", 1))
    pool = tf.make_pool(seed, cfg, traffic, device)
    picks = tf.sample_images(seed, B, len(entry.images_per_card(
        cfg, traffic, cards)), traffic.get("sample_images"))
    need = list(range(min(int(traffic["sample"]), len(pool))))
    t = time.perf_counter()
    want = reference(entry, cfg, traffic, pool, need, picks, device)
    got = reference(entry, cfg, traffic, pool, need, picks, device,
                    torch.bfloat16)
    checks = Checks()
    for p in need:
        checks.add(got[p][0], want[p][0], got[p][1], want[p][1])
    return {"workload": cell.name, "seed": seed, "control": "bfloat16",
            "correct": checks.correct(), "checks": checks.report(),
            "seconds": time.perf_counter() - t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    for seed in args.seed:
        print(json.dumps(control(cell, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
