"""Build the CUDA kernels of `csrc/` at first use and bind them with ctypes.

Each `.cu` file compiles with its own `nvcc`, all started together, and
the objects link into one shared library with a plain C interface under
`build/dct_carver_tpu_torch/<source hash>/` at the repository root, so a
changed source builds anew and an unchanged one loads the library already
built.  Importing this module needs no compiler: `load()` builds on its
first call, which comes with the first CUDA tensor.

Every C entry point takes its pointers and the stream as `void*` and returns
the `cudaError_t` of its launch; `launch()` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["Kernel", "load", "launch", "build_info", "check_plane"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "dct_carver_tpu_torch"
LIB_NAME = "libdct_carver_kernels.so"
# -fmad=false: no multiply-add contraction anywhere (the chains must round
# each op, like the plain PyTorch versions); never --use_fast_math
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
SIGNATURES = {
    # luma, out, taps (host), B, H, W, n, co, edges, textures, stream
    "dc_energy": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P),
    # E, parents, seams, B, H, W, lo[B], width[B], lo0, width0, rightmost,
    # stream
    "dc_find_seams": (_P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _P),
    # E, parents, seams, front, B, H, W, lo[B], width[B], lo0, width0,
    # rightmost, C, Wt, K, warps, split, max_warps, stream
    "dc_find_seams_tiled": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _P),
    # luma, origcol, energy, seam, luma', origcol', energy', B, H, W, width,
    # widths[B], stream
    "dc_apply": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    # luma, energy, seam, taps (host), B, H, W, Wx, Wg, lo, lo_step, xoff,
    # seam_step, n, co, half, strip_w, edges, textures, stream
    "dc_strip": (_P, _P, _P, _P, *(_I,) * 13, _F, _F, _P),
    # luma, seam, bands, B, H, Wx, Wg, lo, lo_step, xoff, seam_step, n, co,
    # half, strip_w, stream
    "dc_strip_gather": (_P, _P, _P, *(_I,) * 12, _P),
    # energy, strip, seam, B, H, W, Wg, lo, lo_step, seam_step, half,
    # strip_w, stream
    "dc_strip_scatter": (_P, _P, _P, *(_I,) * 9, _P),
    # bands, out, taps (host), rows, n, C, edges, textures, stream
    "dc_band_energy": (_P, _P, _P, _L, _I, _I, _F, _F, _P),
    # msg, out, out_ss, S, Kb, Wl, Hh, lo, width, T, Wt, Hg, stream
    "dc_block_dp": (_P, _P, _L, _I, _I, _I, _I, _I, _P, _I, _I, _I, _P),
    # prev, prev_ss, E, e_ss, lh, rh, out, out_ss, S, Kb, Wl, Hh, lo, width,
    # T, Wt, Hg, stream
    "dc_block_dp_parts": (_P, _L, _P, _L, _P, _P, _P, _L, _I, _I, _I, _I,
                          _I, _P, _I, _I, _I, _P),
    # rows, rows_ss, S, Kb, Wl, Hh, K, lo, entry, rightmost, seg, stream
    "dc_seg_walk": (_P, _L, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P),
    # luma, origcol, energy, seam, edge, incoming, luma', origcol', energy',
    # orig, S, H, Wl, lo, new_width, stream
    "dc_sharded_apply": (*(_P,) * 10, _I, _I, _I, _I, _P, _P),
}


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: its source, the TPU kernel it replaces, and
    how many times its wrapper launched it."""
    name: str
    source: str     # path in the repository
    replaces: str   # file:line of the TPU kernel's pl.pallas_call
    launches: int = 0


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path          # the shared library
    seconds: float      # nvcc time in this process (0.0 when it was cached)
    log: str            # nvcc's output (register and shared-memory use)


_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_INFO: BuildInfo | None = None


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "CUDA kernels of dct_carver_tpu_torch cannot be built")


def _build() -> BuildInfo:
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "nvcc.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildInfo(lib, 0.0, log)
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    objs, procs = [], []
    t0 = time.perf_counter()
    # one nvcc a source, all at once: the build is the sum of the slowest
    # file's time, not of all of them
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = out_dir / f".{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink()
    log = "".join(logs)
    log_path.write_text(log)
    os.replace(tmp, lib)
    return BuildInfo(lib, seconds, log)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use; raises if it cannot be."""
    global _LIB, _INFO
    with _LOCK:
        if _LIB is None:
            info = _build()
            lib = ctypes.CDLL(str(info.path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIB, _INFO = lib, info
        return _LIB


def build_info() -> BuildInfo:
    load()
    return _INFO


def check_plane(name: str, t, dtype, device) -> None:
    """Raise unless tensor `t` is contiguous, of `dtype`, on `device`."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor on {device}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")


def launch(kernel: Kernel, fn_name: str, *args, launches: int = 1) -> None:
    """Call C entry point `fn_name`, raise on a launch error, and count on
    `kernel` the `launches` (kernels and memsets) the entry point makes."""
    err = getattr(load(), fn_name)(*args)
    if err != 0:
        raise RuntimeError(
            f"{kernel.name} kernel ({fn_name}) failed with cudaError_t {err}")
    kernel.launches += launches
