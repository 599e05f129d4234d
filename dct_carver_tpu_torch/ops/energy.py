"""Luma conversion and the public energy-map API (plain PyTorch).

Counterpart of `dct_carver_tpu/ops/energy.py`: the carve-path luma
(`src/render.c:134-157`) and the preview-path luma (`src/render.c:31-59`)
behind one function with a `mode` switch.
"""

from __future__ import annotations

import torch

from .dct import dct_energy_map

__all__ = ["to_luma", "energy_map", "normalize_to_u8", "LUMA_MODES"]

LUMA_MODES = ("bt709", "bt601_studio")


def _divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded.  PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal instead; a divisor on x's device does not.
    The divisor is filled there, not copied from the host, which would wait
    for the device."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def to_luma(image: torch.Tensor, mode: str = "bt709",
            dtype: torch.dtype = torch.float32, *,
            stack: bool = False) -> torch.Tensor:
    """(H, W[, C]) u8/float image -> (H, W) luma plane; with `stack`, a
    (B, H, W[, C]) stack -> (B, H, W), so a gray (B, H, W) stack is never
    read as one (H, W, C) image.

    * "bt709": liblqr carve-path luma, [0,1] scale (src/render.c:314).
    * "bt601_studio": preview-path studio luma, u8 scale with C-truncation
      (src/render.h:5).
    """
    img = image.to(dtype)
    if img.ndim == (3 if stack else 2):
        ch = None
    elif img.shape[-1] == 1:
        img, ch = img[..., 0], None
    else:
        ch = img.shape[-1]

    if mode == "bt709":
        if ch is None:
            return _divide(img, 255.0)
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        return _divide(0.2126 * r + 0.7152 * g + 0.0722 * b, 255.0)
    if mode == "bt601_studio":
        if ch is None:
            return torch.floor(img)
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        return torch.floor(16.0 + r * 0.2568 + g * 0.5041 + b * 0.0979)
    raise ValueError(f"unknown luma mode {mode!r}; options: {LUMA_MODES}")


def energy_map(image: torch.Tensor, blocksize: int = 8, edges: float = 0.0,
               textures: float = 1.0, *, luma: str = "bt709",
               center: str = "carve",
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Full-image DCT energy from an RGB/gray image (src/dct.c:96-110)."""
    plane = to_luma(image, luma, dtype)
    return dct_energy_map(plane, blocksize, edges, textures, center=center)


def normalize_to_u8(energy: torch.Tensor) -> torch.Tensor:
    """Min-max normalize to u8, round half-up (DOUBLE2GUCHAR, src/render.h:6).
    The min and max are each (H, W) plane's own: a (B, H, W) stack is
    normalized image by image."""
    e = energy.to(torch.float32)
    mn = e.amin(dim=(-2, -1), keepdim=True)
    mx = e.amax(dim=(-2, -1), keepdim=True)
    span = mx - mn
    scale = torch.where(mx > mn, torch.full_like(span, 255.0) / span,
                        torch.zeros_like(span))
    return torch.floor((e - mn) * scale + 0.5).to(torch.uint8)
