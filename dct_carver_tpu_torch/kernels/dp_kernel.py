"""Find seams: the CUDA kernels `csrc/find_seam.cu` and
`csrc/find_seam_tiled.cu`, and their plain version `ops/dp.py`
(mask_energy + cumulative_energy + backtrack).

`find_seam` (one (H, W) plane) is the counterpart of
`dct_carver_tpu/pallas/dp_kernel.py::find_seam_pallas`; `find_seams` (a
(B, H, W) stack, one column window per image) of
`dct_carver_tpu/pallas/batch_dp_kernel.py::find_seams_vec`.  Both launch
the same C entry, a plane as a batch of one, and count their launches on
their own records.  Rows wider than one thread block covers (`MAX_WIDTH`)
go, from either, to the tiled kernel (the counterpart of the streamed
route `dp_forward` + `dp_backtrack`), which counts one launch a call on
`TILED_KERNEL`.
"""

from __future__ import annotations

import torch

from ..ops.dp import (check_tie, find_seam as find_seam_plain,
                      find_seam_tiled, mask_energy)
from .build import Kernel, check_plane, launch

__all__ = ["find_seam", "find_seams", "KERNEL", "BATCH_KERNEL",
           "TILED_KERNEL", "MAX_WIDTH"]

KERNEL = Kernel(name="find_seam",
                source="dct_carver_tpu_torch/csrc/find_seam.cu",
                replaces="dct_carver_tpu/pallas/dp_kernel.py:348")
BATCH_KERNEL = Kernel(name="find_seams",
                      source="dct_carver_tpu_torch/csrc/find_seam.cu",
                      replaces="dct_carver_tpu/pallas/batch_dp_kernel.py:"
                               "139,171")
TILED_KERNEL = Kernel(name="find_seam_tiled",
                      source="dct_carver_tpu_torch/csrc/find_seam_tiled.cu",
                      replaces="dct_carver_tpu/pallas/dp_kernel.py:124,184")

# one CTA covers a row of at most 1024 threads of 32 columns each
# (csrc/dp_rows.cuh::chunk_for); wider rows take the tiled kernel
MAX_WIDTH = 32768
# the tiled kernel's rows a launch and owned columns a tile: the extended
# row of TILE_W + 2 * TILE_K columns stays at 4 columns a thread
TILE_K = 128
TILE_W = 4096 - 2 * TILE_K


def parent_pitch(W: int) -> int:
    """The row pitch of the kernel's int8 parents scratch: W rounded up to
    4, so each thread stores its parents four to a 32-bit word."""
    return (W + 3) // 4 * 4


def _pointer_args(width, lo, dev) -> tuple[list, list]:
    """The C entries' (lo[B], width[B]) pointers and (lo0, width0) ints:
    a (B,) int32 tensor on `dev` goes as a pointer (its int 0), an int as
    an int (a null pointer)."""
    ptrs, scalars = [], []
    for name, v in (("lo", lo), ("width", width)):
        if isinstance(v, torch.Tensor):
            check_plane(name, v, torch.int32, dev)
            ptrs.append(v.data_ptr())
            scalars.append(0)
        else:
            ptrs.append(None)
            scalars.append(int(v))
    return ptrs, scalars


def _find_seams_cuda(kernel: Kernel, E: torch.Tensor, width, lo,
                     tie: str) -> torch.Tensor:
    """(B, H, W) -> (B, H) seams in one launch, or through the tiled
    kernel for W > MAX_WIDTH.  `width`/`lo` are ints shared by every image,
    or (B,) int32 tensors on E's device."""
    if E.shape[-1] > MAX_WIDTH:
        return _find_seams_tiled(E, width, lo, tie)
    dev = E.device
    check_plane("energy", E, torch.float32, dev)
    B, H, W = E.shape
    ptrs, scalars = _pointer_args(width, lo, dev)
    parents = torch.empty((B, H, parent_pitch(W)), dtype=torch.int8,
                          device=dev)
    seams = torch.empty((B, H), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        launch(kernel, "dc_find_seams", E.data_ptr(), parents.data_ptr(),
               seams.data_ptr(), B, H, W, *ptrs, *scalars,
               int(tie == "rightmost"), torch.cuda.current_stream().cuda_stream)
    return seams


def _find_seams_tiled(E: torch.Tensor, width, lo, tie: str, *,
                      tile: int = TILE_W, K: int = TILE_K) -> torch.Tensor:
    """(B, H, W) -> (B, H) int32 seams through the tiled kernel at any
    width, `tile` owned columns a CTA and K rows a launch (`width`/`lo` as
    `_find_seams_cuda`); on a CPU tensor its plain algorithm
    (`ops/dp.py::find_seam_tiled`).  The carve sends only W > MAX_WIDTH
    here; the tile and K are for tests and measurements."""
    if not E.is_cuda:
        return find_seam_tiled(E, width, lo, tie, tile=tile,
                               K=K).to(torch.int32)
    dev = E.device
    check_plane("energy", E, torch.float32, dev)
    B, H, W = E.shape
    if tile < 4 or tile % 4 or K < 1 or tile + 2 * ((K + 3) // 4 * 4) \
            > MAX_WIDTH:
        raise ValueError(f"tiled find_seam: tile={tile} (a multiple of 4) "
                         f"and K={K} must keep an extended row of tile + "
                         f"2K within {MAX_WIDTH} columns")
    ptrs, scalars = _pointer_args(width, lo, dev)
    parents = torch.empty((B, H, parent_pitch(W)), dtype=torch.int8,
                          device=dev)
    front = torch.empty((2, B, W), dtype=torch.float32, device=dev)
    seams = torch.empty((B, H), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        launch(TILED_KERNEL, "dc_find_seams_tiled", E.data_ptr(),
               parents.data_ptr(), seams.data_ptr(), front.data_ptr(), B, H,
               W, *ptrs, *scalars, int(tie == "rightmost"), tile, K,
               torch.cuda.current_stream().cuda_stream)
    return seams


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
        return _find_seams_cuda(KERNEL, E[None], int(width), 0, tie)[0]
    return find_seam_plain(mask_energy(E, width), tie=tie).to(torch.int32)


def _check_windows(width, lo, B: int, W: int, device) -> None:
    """Raise unless every image's window [lo, lo + width) is non-empty and
    inside [0, W).  Tensors are (B,) int32 on `device`; checking their
    values waits for the device."""
    tensors = [v for v in (width, lo) if isinstance(v, torch.Tensor)]
    for v in tensors:
        if v.shape != (B,) or v.dtype != torch.int32 or v.device != device:
            raise ValueError(f"width/lo must be ints or ({B},) int32 tensors "
                             f"on {device}, got {tuple(v.shape)} {v.dtype} "
                             f"on {v.device}")
    w = width.to(torch.int64) if isinstance(width, torch.Tensor) else width
    o = lo.to(torch.int64) if isinstance(lo, torch.Tensor) else lo
    ok = (w >= 1) & (o >= 0) & (o + w <= W)
    if not bool(torch.as_tensor(ok).all()):
        raise ValueError(f"every window [lo, lo + width) must be non-empty "
                         f"and inside [0, {W})")


def find_seams(E: torch.Tensor, width, lo=0, *, tie: str = "leftmost",
               use_pallas: bool = True) -> torch.Tensor:
    """Masked find-seam of each image of a stack over its own column window
    [lo_b, lo_b + width_b): (B, H, W) energy -> (B, H) int32 seams, the
    seam each image gets alone.  `width` and `lo` are ints shared by every
    image (the carve loop's case, which never waits for the device) or (B,)
    int32 tensors.  A CUDA tensor with `use_pallas` goes to the kernel, one
    launch for the batch; any other tensor to the plain version."""
    check_tie(tie)
    if E.ndim != 3:
        raise ValueError(f"energy must be (B, H, W), got {tuple(E.shape)}")
    _check_windows(width, lo, E.shape[0], E.shape[2], E.device)
    if E.is_cuda and use_pallas:
        return _find_seams_cuda(BATCH_KERNEL, E, width, lo, tie)
    return find_seam_plain(mask_energy(E, width, lo), tie=tie).to(torch.int32)
