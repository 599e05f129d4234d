"""Strip energy updates: four CUDA kernels and their plain versions.

- `strip_update`: `csrc/strip.cu`, the DCT strip in one per-row kernel;
  plain version `ops/strip.py::_recompute_strip`.  Counterpart of
  `dct_carver_tpu/pallas/strip_kernel.py::strip_update_packed` (gather2 ->
  chains -> scatter2) and, for a (B, H, W) stack, of its batched form
  (reached under `jax.vmap` through `_strip_packed_cv`).
- `strip_gather`, `strip_scatter`: `csrc/strip_bands.cu`, the two halves of
  a plugged energy's strip update around its own `bands_fn`; plain versions
  `ops/strip.py::_gather_strip_bands` and `_scatter_strips`.  Counterparts
  of `gather_slabs` (`_gather_slabs_call`) and `scatter_strips`
  (`_scatter_strips_call`).  Both are far shorter than their launch; in a
  carve on the card they run as nodes of the seam step's CUDA graph
  (`utils/graphs.py::GraphedSteps`), launched by the replay with no host
  work.
- `band_energy`: `csrc/strip_bands.cu`, the DCT energy of gathered bands;
  plain version `ops/dct.py::energy_from_bands`.  Counterpart of
  `strip_energy_pallas` (`_strip_energy_call`).

All take the port's per-row strip geometry (`ops/strip.py::_strip_bounds`).
`strip_update`, `strip_gather` and `strip_scatter` also take a stack of the
column shards of one image (`shard=ops.strip.ShardOffset`, the spatial
route): each shard reads its luma with a halo, computes the overlap of each
row's strip with its own columns, and writes only those.  This is the
counterpart of `dct_carver_tpu/parallel/spatial.py::
_sharded_strip_update_pallas`, whose signed window starts do the same for
the TPU's R-row slabs.
"""

from __future__ import annotations

import torch

from ..ops.dct import BLOCKSIZES, energy_from_bands, window_offset
from ..ops.strip import (ShardOffset, _gather_strip_bands, _recompute_strip,
                         _scatter_strips, _strip_extent)
from .build import Kernel, check_plane, launch
from .energy_kernel import host_taps

__all__ = ["strip_update", "strip_gather", "strip_scatter", "band_energy",
           "KERNEL", "GATHER_KERNEL", "SCATTER_KERNEL", "BAND_KERNEL"]

KERNEL = Kernel(name="strip",
                source="dct_carver_tpu_torch/csrc/strip.cu",
                replaces="dct_carver_tpu/pallas/strip_kernel.py:583")
GATHER_KERNEL = Kernel(name="strip_gather",
                       source="dct_carver_tpu_torch/csrc/strip_bands.cu",
                       replaces="dct_carver_tpu/pallas/strip_kernel.py:138")
SCATTER_KERNEL = Kernel(name="strip_scatter",
                        source="dct_carver_tpu_torch/csrc/strip_bands.cu",
                        replaces="dct_carver_tpu/pallas/strip_kernel.py:288")
BAND_KERNEL = Kernel(name="band_energy",
                     source="dct_carver_tpu_torch/csrc/strip_bands.cu",
                     replaces="dct_carver_tpu/pallas/strip_kernel.py:401")


def _layout(shape, W: int, luma_w: int, seam: torch.Tensor, n: int,
            shard, what: str):
    """(B, (Wg, lo, lo_step, xoff, seam_step)) of the kernels for planes of
    `shape` (..., H, ...) whose energy is W and luma `luma_w` columns wide:
    a (H, W) plane or a (B, H, W) stack of images, each with its own seam,
    or with `shard` a (S, H, Wl) stack of shards of one image with the (H,)
    seam they share and their halo-extended luma.  Raises on any other
    layout, and past the grid's z limit."""
    H = shape[-2]
    B = shape[0] if len(shape) == 3 else 1
    if B > 65535:
        raise ValueError(f"{what} kernel: {B} images exceed the grid's 65535")
    if shard is None:
        if luma_w != W or tuple(seam.shape) != tuple(shape[:-1]):
            raise ValueError(f"{what}: (..., H, W) planes and (..., H) "
                             "seams expected")
        return B, (W, 0, 0, 0, H)
    if len(shape) != 3 or tuple(seam.shape) != (H,) or luma_w != W + n - 1:
        raise ValueError(f"{what}: shards want (S, H, Wl) planes, a (H,) "
                         f"seam and (S, H, Wl + {n - 1}) luma")
    return B, (shard.width, shard.lo, W, n // 2 - 1, 0)


def _check_fits(W: int, n: int, delta_x: int) -> tuple[int, int]:
    half, strip_w = _strip_extent(n, delta_x)
    if W < strip_w:
        raise ValueError(f"strip of {strip_w} columns does not fit width "
                         f"{W}: recompute the full map")
    return half, strip_w


def _strip_cuda(luma, energy, seam, n, edges, textures, delta_x, shard):
    dev = luma.device
    check_plane("luma", luma, torch.float32, dev)
    check_plane("energy", energy, torch.float32, dev)
    check_plane("seam", seam, torch.int32, dev)
    if energy.shape[:-1] != luma.shape[:-1]:
        raise ValueError("strip: luma and energy differ in shape")
    H, W = energy.shape[-2:]
    B, geometry = _layout(energy.shape, W, luma.shape[-1], seam, n, shard,
                          "strip")
    half, strip_w = _strip_extent(n, delta_x)
    with torch.cuda.device(dev):
        launch(KERNEL, "dc_strip", luma.data_ptr(), energy.data_ptr(),
               seam.data_ptr(), host_taps(n).ctypes.data, B, H, W,
               luma.shape[-1], *geometry, n, window_offset(n, "carve"), half,
               strip_w, float(edges), float(textures),
               torch.cuda.current_stream().cuda_stream)
    return energy


def _global_width(plane: torch.Tensor, shard) -> int:
    return plane.shape[-1] if shard is None else shard.width


def strip_update(luma: torch.Tensor, energy: torch.Tensor,
                 seam: torch.Tensor, blocksize: int, edges, textures, *,
                 delta_x: int = 1, use_pallas: bool = True,
                 shard: ShardOffset | None = None) -> torch.Tensor:
    """Recompute, in place, each row's strip of the compacted `energy`
    around the removed `seam` from the compacted, edge-filled `luma`, and
    return `energy`.  luma, energy: (H, W) with a (H,) seam, or (B, H, W)
    with (B, H) seams; with `shard`, (S, H, Wl) shards of one image with
    their (S, H, Wl + n - 1) halo-extended luma and the (H,) seam.  A CUDA
    tensor with `use_pallas` goes to the kernel; any other tensor to the
    plain version."""
    _check_fits(_global_width(energy, shard), blocksize, delta_x)
    if luma.is_cuda and use_pallas:
        return _strip_cuda(luma, energy, seam, blocksize, edges, textures,
                           delta_x, shard)
    return _recompute_strip(luma, energy, seam, blocksize, edges, textures,
                            delta_x, shard)


def strip_gather(luma: torch.Tensor, seam: torch.Tensor, n: int, *,
                 delta_x: int = 1, use_pallas: bool = True,
                 shard: ShardOffset | None = None) -> torch.Tensor:
    """Each row's band around the removed `seam`, read from the compacted,
    edge-filled `luma`: (..., H, W) with (..., H) seams -> (..., H, n,
    strip_w + n - 1), the input of an n-wide energy's `bands_fn` for the
    row's strip; with `shard`, the (S, H, Wl + n - 1) halo-extended luma of
    shards of one image and the (H,) seam -> (S, H, n, strip_w + n - 1).
    `n`: any even window size.  A CUDA tensor with `use_pallas` goes to the
    kernel; any other tensor to the plain version."""
    H, Wx = luma.shape[-2:]
    half, strip_w = _check_fits(_global_width(luma, shard), n, delta_x)
    if not (luma.is_cuda and use_pallas):
        return _gather_strip_bands(luma, seam, n, delta_x, shard)
    dev = luma.device
    check_plane("luma", luma, torch.float32, dev)
    check_plane("seam", seam, torch.int32, dev)
    B, geometry = _layout(luma.shape, Wx - (n - 1 if shard else 0), Wx,
                          seam, n, shard, "strip_gather")
    bands = torch.empty((*luma.shape[:-1], n, strip_w + n - 1),
                        dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        launch(GATHER_KERNEL, "dc_strip_gather", luma.data_ptr(),
               seam.data_ptr(), bands.data_ptr(), B, H, Wx, *geometry, n,
               window_offset(n, "carve"), half, strip_w,
               torch.cuda.current_stream().cuda_stream)
    return bands


def strip_scatter(energy: torch.Tensor, strip: torch.Tensor,
                  seam: torch.Tensor, n: int, *, delta_x: int = 1,
                  use_pallas: bool = True,
                  shard: ShardOffset | None = None) -> torch.Tensor:
    """Write, in place, each row's (..., H, strip_w) `strip` into the
    compacted `energy` (..., H, W) at the row's strip start, and return
    `energy`; with `shard`, (S, H, Wl) shards of one image with the (H,)
    seam, each keeping the strip columns it owns.  A CUDA tensor with
    `use_pallas` goes to the kernel; any other tensor to the plain
    version."""
    H, W = energy.shape[-2:]
    half, strip_w = _check_fits(_global_width(energy, shard), n, delta_x)
    if strip.shape != (*energy.shape[:-1], strip_w):
        raise ValueError(f"strip: expected shape "
                         f"{(*energy.shape[:-1], strip_w)}, got "
                         f"{tuple(strip.shape)}")
    if not (energy.is_cuda and use_pallas):
        return _scatter_strips(energy, strip, seam, n, delta_x, shard)
    dev = energy.device
    check_plane("energy", energy, torch.float32, dev)
    check_plane("strip", strip, torch.float32, dev)
    check_plane("seam", seam, torch.int32, dev)
    B, (Wg, lo, lo_step, _, seam_step) = _layout(
        energy.shape, W, W + (n - 1 if shard else 0), seam, n, shard,
        "strip_scatter")
    with torch.cuda.device(dev):
        launch(SCATTER_KERNEL, "dc_strip_scatter", energy.data_ptr(),
               strip.data_ptr(), seam.data_ptr(), B, H, W, Wg, lo, lo_step,
               seam_step, half, strip_w,
               torch.cuda.current_stream().cuda_stream)
    return energy


def band_energy(bands: torch.Tensor, n: int, edges, textures, *,
                use_pallas: bool = True) -> torch.Tensor:
    """DCT energy of every sliding window of per-row bands: (..., n, C) ->
    (..., C - n + 1), f32.  A CUDA tensor with `use_pallas` goes to the
    kernel (f32 only); any other tensor to the plain version."""
    if n not in BLOCKSIZES:
        raise ValueError(f"blocksize must be one of {BLOCKSIZES}, got {n}")
    if bands.ndim < 2 or bands.shape[-2] != n or bands.shape[-1] < n:
        raise ValueError(f"bands must be (..., {n}, C >= {n}), got "
                         f"{tuple(bands.shape)}")
    if not (bands.is_cuda and use_pallas):
        return energy_from_bands(bands, n, edges, textures).to(torch.float32)
    dev = bands.device
    check_plane("bands", bands, torch.float32, dev)
    C = bands.shape[-1]
    out = torch.empty((*bands.shape[:-2], C - n + 1), dtype=torch.float32,
                      device=dev)
    rows = out.numel() // (C - n + 1)
    if rows == 0:
        return out
    with torch.cuda.device(dev):
        launch(BAND_KERNEL, "dc_band_energy", bands.data_ptr(),
               out.data_ptr(), host_taps(n).ctypes.data, rows, n, C,
               float(edges), float(textures),
               torch.cuda.current_stream().cuda_stream)
    return out
