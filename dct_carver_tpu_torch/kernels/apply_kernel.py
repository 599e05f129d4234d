"""Seam apply: the CUDA kernel `csrc/apply.cu` and its plain version
(`ops/dp.py::remove_seam` on the three planes + `ops/strip.py::_edge_fill`).

Counterpart of `dct_carver_tpu/pallas/apply_kernel.py::apply_seam_pallas`
together with its `new_edge_value`, and, for a (B, H, W) stack, of its
batched form `_apply_seam_batched` (reached under `jax.vmap` through
`_apply_cv`).
"""

from __future__ import annotations

import torch

from ..ops.dp import remove_seam
from ..ops.strip import _edge_fill
from .build import Kernel, check_plane, launch

__all__ = ["apply_seam", "KERNEL"]

KERNEL = Kernel(name="apply",
                source="dct_carver_tpu_torch/csrc/apply.cu",
                replaces="dct_carver_tpu/pallas/apply_kernel.py:105")


def _apply_cuda(luma, origcol, energy, seam, width, out):
    dev = luma.device
    B = luma.shape[0] if luma.ndim == 3 else 1
    H, W = luma.shape[-2:]
    for name, t, dtype in (("luma", luma, torch.float32),
                           ("origcol", origcol, torch.int32),
                           ("energy", energy, torch.float32),
                           ("seam", seam, torch.int32)):
        check_plane(name, t, dtype, dev)
    if (origcol.shape != luma.shape or energy.shape != luma.shape
            or seam.shape != luma.shape[:-1]):
        raise ValueError("apply: luma/origcol/energy (..., H, W) and seam "
                         "(..., H) expected")
    if out is None:
        out = (torch.empty_like(luma), torch.empty_like(origcol),
               torch.empty_like(energy))
    for name, o, src in zip(("luma out", "origcol out", "energy out"), out,
                            (luma, origcol, energy)):
        check_plane(name, o, src.dtype, dev)
        if o.shape != src.shape or o.data_ptr() == src.data_ptr():
            raise ValueError(f"{name}: needs a separate buffer of shape "
                             f"{tuple(src.shape)}")
    if B > 65535:
        raise ValueError(f"apply kernel: {B} images exceed the grid's 65535")
    if isinstance(width, torch.Tensor):
        check_plane("width", width, torch.int32, dev)
        if width.shape != (B,):
            raise ValueError(f"width: expected ({B},), got "
                             f"{tuple(width.shape)}")
        width, widths = 0, width.data_ptr()
    else:
        widths = None
    with torch.cuda.device(dev):
        launch(KERNEL, "dc_apply", luma.data_ptr(), origcol.data_ptr(),
               energy.data_ptr(), seam.data_ptr(), out[0].data_ptr(),
               out[1].data_ptr(), out[2].data_ptr(), B, H, W, width, widths,
               torch.cuda.current_stream().cuda_stream)
    return out


def apply_seam(luma: torch.Tensor, origcol: torch.Tensor,
               energy: torch.Tensor, seam: torch.Tensor, width, *,
               out=None, use_pallas: bool = True):
    """Compact (luma, origcol, energy) around `seam` and edge-fill luma from
    `width - 1` on.  `width` is the logical width BEFORE the removal.  The
    planes are (H, W) with a (H,) seam, or (B, H, W) with (B, H) seams and
    one shared width.  `width` is an int, or a (B,) int32 tensor on the
    planes' device ((1,) for a plane) that the kernel reads there, so a
    seam step can keep it on the device; its value is not checked, since
    that would wait for the device.

    With CUDA tensors and `use_pallas`, the kernel writes into `out` (a
    (luma, origcol, energy) set of separate buffers, allocated when None);
    the plain version returns new tensors and ignores `out`.
    """
    if not isinstance(width, torch.Tensor):
        if not 2 <= width <= luma.shape[-1]:
            raise ValueError(f"width {width} outside [2, {luma.shape[-1]}]")
        width = int(width)
    if luma.is_cuda and use_pallas:
        return _apply_cuda(luma, origcol, energy, seam, width, out)
    return (_edge_fill(remove_seam(luma, seam), width - 1),
            remove_seam(origcol, seam), remove_seam(energy, seam))
