"""Full DCT energy map: the CUDA kernel `csrc/energy.cu` and its plain
version `ops/dct.py::dct_energy_map`.

Counterpart of `dct_carver_tpu/pallas/energy_kernel.py::dct_energy_pallas`
and, for a (B, H, W) stack, of its batched form `_energy_pallas_batched`
(reached under `jax.vmap` through `_energy_cv`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.dct import (BLOCKSIZES, _dct_matrix_np, dct_energy_map,
                       window_offset)
from .build import Kernel, check_plane, launch

__all__ = ["dct_energy", "KERNEL", "host_taps"]

KERNEL = Kernel(name="energy",
                source="dct_carver_tpu_torch/csrc/energy.cu",
                replaces="dct_carver_tpu/pallas/energy_kernel.py:170")


@functools.lru_cache(maxsize=None)
def host_taps(n: int) -> np.ndarray:
    """The (n, n) f32 DCT taps in host memory, kept alive here: the energy
    and strip kernels take them by value as a kernel parameter, never
    cosines computed on the device."""
    return np.ascontiguousarray(_dct_matrix_np(n).astype(np.float32))


def _energy_cuda(luma: torch.Tensor, n: int, edges, textures,
                 center: str) -> torch.Tensor:
    check_plane("luma", luma, torch.float32, luma.device)
    B = luma.shape[0] if luma.ndim == 3 else 1
    H, W = luma.shape[-2:]
    if B > 65535:
        raise ValueError(f"energy kernel: {B} images exceed the grid's 65535")
    out = torch.empty_like(luma)
    with torch.cuda.device(luma.device):
        launch(KERNEL, "dc_energy", luma.data_ptr(), out.data_ptr(),
               host_taps(n).ctypes.data, B, H, W, n, window_offset(n, center),
               float(edges), float(textures),
               torch.cuda.current_stream().cuda_stream)
    return out


def dct_energy(luma: torch.Tensor, blocksize: int, edges, textures, *,
               center: str = "carve", use_pallas: bool = True) -> torch.Tensor:
    """(H, W) luma -> (H, W) f32 energy, or (B, H, W) -> (B, H, W) in one
    launch.  A CUDA tensor with `use_pallas` goes to the kernel (f32 only;
    anything else raises); any other tensor to the plain version, computed
    in its own dtype and then cast."""
    if luma.ndim not in (2, 3):
        raise ValueError(f"luma must be (H, W) or (B, H, W), got "
                         f"{tuple(luma.shape)}")
    if blocksize not in BLOCKSIZES:
        raise ValueError(f"blocksize must be one of {BLOCKSIZES}, got "
                         f"{blocksize}")
    if luma.is_cuda and use_pallas:
        return _energy_cuda(luma, blocksize, edges, textures, center)
    return dct_energy_map(luma, blocksize, edges, textures,
                          center=center).to(torch.float32)
