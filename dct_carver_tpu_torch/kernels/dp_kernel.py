"""Find one seam: the CUDA kernel `csrc/find_seam.cu` and its plain version
`ops/dp.py` (mask_energy + cumulative_energy + backtrack).

Counterpart of `dct_carver_tpu/pallas/dp_kernel.py::find_seam_pallas`.
"""

from __future__ import annotations

import torch

from ..ops.dp import check_tie, find_seam as find_seam_plain, mask_energy
from .build import Kernel, check_plane, launch

__all__ = ["find_seam", "KERNEL", "MAX_WIDTH"]

KERNEL = Kernel(name="find_seam",
                source="dct_carver_tpu_torch/csrc/find_seam.cu",
                replaces="dct_carver_tpu/pallas/dp_kernel.py:348")

# the double-buffered frontier (2 * W f32) plus the reduction scratch must
# fit one block's 227 KB of shared memory
_SMEM_LIMIT = 232448
_REDUCTION_BYTES = 256
MAX_WIDTH = (_SMEM_LIMIT - _REDUCTION_BYTES) // 8


def _find_seam_cuda(E: torch.Tensor, width: int, tie: str) -> torch.Tensor:
    check_plane("energy", E, torch.float32, E.device)
    H, W = E.shape
    if W > MAX_WIDTH:
        raise ValueError(
            f"find_seam kernel: width {W} exceeds {MAX_WIDTH}, the most "
            "whose frontier fits one block's shared memory")
    parents = torch.empty((H, W), dtype=torch.int8, device=E.device)
    seam = torch.empty((H,), dtype=torch.int32, device=E.device)
    with torch.cuda.device(E.device):
        # the kernel's column window [lo, lo + width) starts at lo = 0 here
        launch(KERNEL, "dc_find_seam", E.data_ptr(), parents.data_ptr(),
               seam.data_ptr(), H, W, 0, width, int(tie == "rightmost"),
               torch.cuda.current_stream().cuda_stream)
    return seam


def find_seam(E: torch.Tensor, width: int, *, tie: str = "leftmost",
              use_pallas: bool = True) -> torch.Tensor:
    """Masked find-seam over the live columns [0, width): (H, W) energy ->
    (H,) int32 seam.  A CUDA tensor with `use_pallas` goes to the kernel;
    any other tensor to the plain version."""
    check_tie(tie)
    if E.ndim != 2:
        raise ValueError(f"energy must be (H, W), got {tuple(E.shape)}")
    if not 1 <= width <= E.shape[1]:
        raise ValueError(f"width {width} outside [1, {E.shape[1]}]")
    if E.is_cuda and use_pallas:
        return _find_seam_cuda(E, int(width), tie)
    return find_seam_plain(mask_energy(E, width), tie=tie).to(torch.int32)
