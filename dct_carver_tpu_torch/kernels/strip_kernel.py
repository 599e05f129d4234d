"""Strip energy update: the CUDA kernel `csrc/strip.cu` and its plain
version `ops/carve.py::_recompute_strip`.

Counterpart of `dct_carver_tpu/pallas/strip_kernel.py::strip_update_packed`
(gather2 -> chains -> scatter2), as one per-row strip kernel, and, for a
(B, H, W) stack, of its batched form (reached under `jax.vmap` through
`_strip_packed_cv`).
"""

from __future__ import annotations

import torch

from ..ops.carve import _recompute_strip, _strip_extent
from ..ops.dct import window_offset
from .build import Kernel, check_plane, launch
from .energy_kernel import dct_taps

__all__ = ["strip_update", "KERNEL"]

KERNEL = Kernel(name="strip",
                source="dct_carver_tpu_torch/csrc/strip.cu",
                replaces="dct_carver_tpu/pallas/strip_kernel.py:583")


def _strip_cuda(luma, energy, seam, n, edges, textures, delta_x):
    dev = luma.device
    B = luma.shape[0] if luma.ndim == 3 else 1
    H, W = luma.shape[-2:]
    check_plane("luma", luma, torch.float32, dev)
    check_plane("energy", energy, torch.float32, dev)
    check_plane("seam", seam, torch.int32, dev)
    if energy.shape != luma.shape or seam.shape != luma.shape[:-1]:
        raise ValueError("strip: luma/energy (..., H, W) and seam (..., H) "
                         "expected")
    if B > 65535:
        raise ValueError(f"strip kernel: {B} images exceed the grid's 65535")
    half, strip_w = _strip_extent(n, delta_x)
    taps = dct_taps(n, dev)
    with torch.cuda.device(dev):
        launch(KERNEL, "dc_strip", luma.data_ptr(), energy.data_ptr(),
               seam.data_ptr(), taps.data_ptr(), B, H, W, n,
               window_offset(n, "carve"), half, strip_w, float(edges),
               float(textures), torch.cuda.current_stream().cuda_stream)
    return energy


def strip_update(luma: torch.Tensor, energy: torch.Tensor,
                 seam: torch.Tensor, blocksize: int, edges, textures, *,
                 delta_x: int = 1, use_pallas: bool = True) -> torch.Tensor:
    """Recompute, in place, each row's strip of the compacted `energy`
    around the removed `seam` from the compacted, edge-filled `luma`, and
    return `energy`.  luma, energy: (H, W) with a (H,) seam, or (B, H, W)
    with (B, H) seams.  A CUDA tensor with `use_pallas` goes to the kernel;
    any other tensor to the plain version."""
    strip_w = _strip_extent(blocksize, delta_x)[1]
    if luma.shape[-1] < strip_w:
        raise ValueError(f"strip of {strip_w} columns does not fit width "
                         f"{luma.shape[-1]}: recompute the full map")
    if luma.is_cuda and use_pallas:
        return _strip_cuda(luma, energy, seam, blocksize, edges, textures,
                           delta_x)
    return _recompute_strip(luma, energy, seam, blocksize, edges, textures,
                            delta_x)
