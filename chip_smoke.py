#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`dct_carver_tpu_torch`) once on one NVIDIA card.

    python3 chip_smoke.py

Phase 0 builds the four CUDA kernels from `dct_carver_tpu_torch/csrc/`.
Phase 1 holds each kernel against its plain PyTorch version on the card,
bit for bit, at the main path's shapes (1080x1920, and 2160x3840 at n=16),
and times both.  Phase 2 runs the main path through the public API: a
64-seam removal from a 1080x1920 RGB image with the launch counters read
around it, compared element for element with the plain path on the card
and with the CPU on a small image; then a bidirectional 4K resize at n=16.

The last stdout line is {"ok": true, "device": {...}}; before it come the
kernels' JSON line and the card's name and power limit.  Any failed phase
exits non-zero and prints no result.  Imports nothing of JAX.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 20261016
H, W = 1080, 1920          # the headline shape (BASELINE config 1)
H4, W4 = 2160, 3840        # BASELINE config 3
SEAMS = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class Checks:
    """Bitwise comparisons of a kernel with its plain version; the largest
    absolute difference per kernel, and every failure."""

    def __init__(self):
        self.max_err: dict[str, float] = {}
        self.failures: list[str] = []

    def equal(self, kernel: str, case: str, got, want) -> None:
        import torch

        if got.shape != want.shape or got.dtype != want.dtype:
            self.failures.append(f"{kernel} {case}: {tuple(got.shape)} "
                                 f"{got.dtype} vs {tuple(want.shape)} "
                                 f"{want.dtype}")
            return
        diff = (got.double() - want.double()).abs()
        diff = torch.nan_to_num(diff, nan=float("inf"), posinf=float("inf"))
        err = float(diff.max()) if diff.numel() else 0.0
        same = bool(torch.equal(got, want))
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), err)
        log(f"  {kernel:9s} {case:44s} {'bitwise' if same else 'DIFFERS'}"
            f"  max_abs_err={err!r}")
        if not same:
            self.failures.append(f"{kernel} {case}: max_abs_err={err!r}")

    def require(self, ok: bool, what: str) -> None:
        log(f"  {'ok  ' if ok else 'FAIL'} {what}")
        if not ok:
            self.failures.append(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over `reps` calls, after one
    warm-up call, between CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn, top: int = 8):
    """Run fn() once warm under torch.profiler: (wall seconds, device
    microseconds summed over kernels, the `top` kernels by device time as
    (name, us, count))."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return wall, sum(r[1] for r in rows), rows[:top]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    import dct_carver_tpu_torch
    if Path(dct_carver_tpu_torch.__file__).resolve().parents[1] != ROOT:
        print(f"chip_smoke: dct_carver_tpu_torch comes from "
              f"{dct_carver_tpu_torch.__file__}, not from {ROOT}",
              file=sys.stderr)
        return 2

    from dct_carver_tpu_torch import api, kernels
    from dct_carver_tpu_torch.kernels import build
    from dct_carver_tpu_torch.kernels.apply_kernel import apply_seam
    from dct_carver_tpu_torch.kernels.dp_kernel import find_seam
    from dct_carver_tpu_torch.kernels.energy_kernel import dct_energy
    from dct_carver_tpu_torch.kernels.strip_kernel import strip_update
    from dct_carver_tpu_torch.models.carver import Carver
    from dct_carver_tpu_torch.ops.carve import carve_n_seams
    from dct_carver_tpu_torch.ops.energy import to_luma

    # ---------------------------------------------------------- phase 0 --
    card = card_line()
    dev = torch.device("cuda", 0)
    log(f"phase 0: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.load()
    info = build.build_info()
    log(f"  kernels built in {info.seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s): {info.path}")
    for line in info.log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            log(f"  ptxas: {line.strip()}")

    rng = np.random.default_rng(SEED)
    chk = Checks()
    edges, textures = 0.3, 0.7

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---------------------------------------------------------- phase 1 --
    log(f"phase 1: kernels vs plain versions on the card ({H}x{W}, "
        f"{H4}x{W4})")
    luma = on_card(rng.random((H, W), dtype=np.float32))
    luma_q = on_card((rng.integers(0, 3, (H, W)) / 2).astype(np.float32))
    luma4 = on_card(rng.random((H4, W4), dtype=np.float32))

    def energy_pair(x, n, center="carve"):
        return (dct_energy(x, n, edges, textures, center=center),
                dct_energy(x, n, edges, textures, center=center,
                           use_pallas=False))

    for n in (2, 4, 8, 16):
        for center in ("carve", "preview"):
            chk.equal("energy", f"{H}x{W} n={n} {center}",
                      *energy_pair(luma, n, center))
    chk.equal("energy", f"{H}x{W} n=8 quantized luma",
              *energy_pair(luma_q, 8))
    chk.equal("energy", f"{H4}x{W4} n=16", *energy_pair(luma4, 16))
    ragged = luma[: H - 3, : W - 7].contiguous()  # no multiple of a block
    for n in (8, 16):
        chk.equal("energy", f"{H - 3}x{W - 7} n={n}", *energy_pair(ragged, n))

    E = dct_energy(luma, 8, edges, textures)
    E_q = on_card((rng.integers(0, 4, (H, W)) / 4).astype(np.float32))
    E4 = dct_energy(luma4, 16, edges, textures)
    E_r = dct_energy(ragged, 8, edges, textures)
    for name, e, width in (("1080p energy", E, W),
                           ("1080p energy width=W-37", E, W - 37),
                           ("1080p quantized energy", E_q, W),
                           (f"{H - 3}x{W - 7} energy", E_r, W - 7),
                           ("4K n=16 energy", E4, W4)):
        for tie in ("leftmost", "rightmost"):
            chk.equal("find_seam", f"{name} {tie}",
                      find_seam(e, width, tie=tie),
                      find_seam(e, width, tie=tie, use_pallas=False))
    # 8K: the frontier (2 * 7680 f32) is past the 48 KB default of shared
    # memory, so this takes the kernel's opt-in launch
    E8 = on_card(rng.random((4320, 7680), dtype=np.float32))
    chk.equal("find_seam", "4320x7680 random energy leftmost",
              find_seam(E8, 7680), find_seam(E8, 7680, use_pallas=False))
    del E8

    origcol = on_card(rng.integers(0, 4 * W, (H, W)).astype(np.int32))
    for mode in ("interior", "left", "right-edge", "shrunk"):
        width = W - 5 if mode == "shrunk" else W
        if mode == "interior":
            s = (np.cumsum(rng.integers(-1, 2, H)) + 100) % (width - 2) + 1
        elif mode == "left":
            s = np.minimum(np.arange(H), 2)
        elif mode == "right-edge":
            s = np.full(H, width - 1)
        else:
            s = np.full(H, width - 3)
        seam = on_card(s.astype(np.int32))
        got = apply_seam(luma, origcol, E, seam, width)
        want = apply_seam(luma, origcol, E, seam, width, use_pallas=False)
        for part, g, w_ in zip(("luma", "origcol", "energy"), got, want):
            chk.equal("apply", f"1080p {mode} {part}", g, w_)
    # the seam lies inside the live width, as the carve's DP gives it
    seam4 = find_seam(E4, W4 - 2)
    oc4 = torch.zeros_like(luma4, dtype=torch.int32)
    for part, g, w_ in zip(
            ("luma", "origcol", "energy"),
            apply_seam(luma4, oc4, E4, seam4, W4 - 2),
            apply_seam(luma4, oc4, E4, seam4, W4 - 2, use_pallas=False)):
        chk.equal("apply", f"4K width=W-2 {part}", g, w_)

    for name, x, n in (("1080p n=8", luma, 8), ("4K n=16", luma4, 16),
                       (f"{H - 3}x{W - 7} n=16", ragged, 16)):
        e0 = dct_energy(x, n, edges, textures)
        seam = find_seam(e0, x.shape[1])
        l1, _, e1 = apply_seam(x, torch.zeros_like(x, dtype=torch.int32),
                               e0, seam, x.shape[1], use_pallas=False)
        k = strip_update(l1, e1.clone(), seam, n, edges, textures)
        p = strip_update(l1, e1.clone(), seam, n, edges, textures,
                         use_pallas=False)
        chk.equal("strip", f"{name} after one seam", k, p)
        live = x.shape[1] - 1
        full = dct_energy(l1, n, edges, textures, use_pallas=False)
        chk.equal("strip", f"{name} == full recompute (live columns)",
                  k[:, :live].contiguous(), full[:, :live].contiguous())

    # per-kernel times at the 1080p n=8 main-path shapes
    seam = find_seam(E, W)
    outs = tuple(torch.empty_like(t) for t in (luma, origcol, E))
    e_strip = E.clone()
    times = {
        "energy": (cuda_ms(lambda: dct_energy(luma, 8, edges, textures), 20),
                   cuda_ms(lambda: dct_energy(luma, 8, edges, textures,
                                              use_pallas=False), 3)),
        "find_seam": (cuda_ms(lambda: find_seam(E, W), 20),
                      cuda_ms(lambda: find_seam(E, W, use_pallas=False), 2)),
        "apply": (cuda_ms(lambda: apply_seam(luma, origcol, E, seam, W,
                                             out=outs), 50),
                  cuda_ms(lambda: apply_seam(luma, origcol, E, seam, W,
                                             use_pallas=False), 20)),
        "strip": (cuda_ms(lambda: strip_update(luma, e_strip, seam, 8, edges,
                                               textures), 50),
                  cuda_ms(lambda: strip_update(luma, e_strip, seam, 8, edges,
                                               textures, use_pallas=False),
                          20)),
    }
    for name, (k_ms, p_ms) in times.items():
        log(f"  {name:9s} kernel {k_ms!r} ms, plain {p_ms!r} ms "
            f"(1080x1920 n=8; {card})")

    # ---------------------------------------------------------- phase 2 --
    log(f"phase 2: api.carve({H}x{W}x3, -{SEAMS}, blocksize=8) on the card")
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    kw = dict(blocksize=8, output_seams=True, output_energy=True,
              device="cuda")
    api.carve(img[:64, :256], -4, **kw)  # warm-up (allocator, streams)
    torch.cuda.synchronize()
    kernels.reset_launches()
    res = api.carve(img, -SEAMS, **kw)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"  launches on the main path: {launches}")
    chk.require(launches["energy"] >= 1, "energy kernel launched")
    for name in ("find_seam", "apply", "strip"):
        chk.require(launches[name] == SEAMS,
                    f"{name} kernel launched {SEAMS} times")

    plain = api.carve(img, -SEAMS, use_pallas=False, **kw)
    for field in ("image", "visibility_map", "energy_image"):
        a, b = getattr(res, field), getattr(plain, field)
        chk.require(a.shape == b.shape and np.array_equal(a, b),
                    f"api.carve {field} == plain path on the card")
    vm = res.visibility_map
    chk.require(res.image.shape == (H, W - SEAMS, 3)
                and res.energy_image.shape == (H, W)
                and res.energy_image.dtype == np.uint8,
                "output shapes and types")
    chk.require(all(((vm == k).sum(axis=1) == 1).all()
                    for k in range(1, SEAMS + 1)),
                "one removed pixel per row per seam")
    small = img[:48, :96]
    a = api.carve(small, -12, **kw)
    b = api.carve(small, -12, blocksize=8, output_seams=True,
                  output_energy=True, device="cpu")
    chk.require(all(np.array_equal(getattr(a, f), getattr(b, f))
                    for f in ("image", "visibility_map", "energy_image")),
                "48x96 carve on the card == the same carve on the CPU")

    def mpix_s(use_pallas: bool, repeats: int) -> float:
        best = float("inf")
        for _ in range(repeats):
            x = to_luma(on_card(rng.integers(0, 256, (H, W, 3),
                                             dtype=np.uint8)))
            torch.cuda.synchronize()
            t = time.perf_counter()
            carve_n_seams(x, SEAMS, 8, 0.0, 1.0, use_pallas=use_pallas)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        return H * W * SEAMS / best / 1e6

    k_rate = mpix_s(True, 3)
    p_rate = mpix_s(False, 1)
    log(f"  headline carve {H}x{W} n=8 {SEAMS} seams: kernel path "
        f"{k_rate!r} Mpix/s, plain path {p_rate!r} Mpix/s ({card})")

    # where the time of the headline carve goes, by kernel, under the profiler
    x = to_luma(on_card(img))
    wall, busy_us, top = device_profile(
        lambda: carve_n_seams(x, SEAMS, 8, 0.0, 1.0))
    log(f"  profiled headline carve: wall {wall * 1e3!r} ms, device busy "
        f"{busy_us / 1e3!r} ms ({100 * busy_us / 1e6 / wall!r} % of wall; "
        f"{card})")
    for name, us, count in top:
        log(f"    {us / 1e3:10.4f} ms  {count:5d} x  {name[:90]}")

    log(f"phase 2b: bidirectional {H4}x{W4} resize, n=16")
    img4 = rng.integers(0, 256, (H4, W4, 3), dtype=np.uint8)
    few = 3
    ka = Carver(img4, blocksize=16, output_seams=True,
                device="cuda").resize(W4 - few, H4 - few)
    pa = Carver(img4, blocksize=16, output_seams=True, device="cuda",
                use_pallas=False).resize(W4 - few, H4 - few)
    chk.require(np.array_equal(ka.image, pa.image)
                and np.array_equal(ka.visibility_map, pa.visibility_map),
                f"4K bidirectional {few}+{few} seams == plain path")
    torch.cuda.synchronize()
    t = time.perf_counter()
    big = Carver(img4, blocksize=16, device="cuda").resize(
        W4 - SEAMS, H4 - SEAMS)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    chk.require(big.image.shape == (H4 - SEAMS, W4 - SEAMS, 3),
                "4K bidirectional output shape")
    px = H4 * W4 * SEAMS + (W4 - SEAMS) * H4 * SEAMS
    log(f"  4K bidirectional {SEAMS}+{SEAMS} seams: {sec!r} s, "
        f"{px / sec / 1e6!r} Mpix/s (kernel path, host round trip "
        f"included; {card})")

    if chk.failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(chk.failures),
              file=sys.stderr)
        return 1
    log(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": chk.max_err[k.name], "ms": times[k.name][0],
         "plain_ms": times[k.name][1]}
        for k in kernels.KERNELS]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
