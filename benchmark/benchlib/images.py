"""Synthetic photo-like images from a seed, made on the device in a few
large calls and copied to the host as the u8 arrays a user hands the
program.

Each image has smooth shading (a base colour, two gradients and a
low-frequency wave), textured patches (noise inside a few rectangles),
and hard-edged flat shapes (rectangles and ellipses of one colour painted
last).  The flat interiors give the seam DP the ties its tie rule decides.
The same seed gives the same images on the same kind of device; every
seed gives images of the same sizes."""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["photos"]

TEXTURES = 3   # textured rectangles an image
RECTS = 5      # flat rectangles an image
ELLIPSES = 4   # flat ellipses an image


def _batch(g: torch.Generator, B: int, H: int, W: int, C: int,
           dev) -> torch.Tensor:
    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    y = torch.linspace(0.0, 1.0, H, device=dev).reshape(1, H, 1, 1)
    x = torch.linspace(0.0, 1.0, W, device=dev).reshape(1, 1, W, 1)
    one = (B, 1, 1, 1)
    img = (40 + 170 * rand(B, 1, 1, C)
           + 120 * (rand(B, 1, 1, C) - 0.5) * (x - 0.5)
           + 120 * (rand(B, 1, 1, C) - 0.5) * (y - 0.5)
           + 25 * torch.sin(2 * math.pi * (1 + 3 * rand(*one)) * x
                            + 2 * math.pi * (1 + 3 * rand(*one)) * y
                            + 2 * math.pi * rand(*one)))

    def box(k):  # k rectangles an image: (B, H, W, 1) masks
        x0, y0 = rand(B, 1, 1, k), rand(B, 1, 1, k)
        x1 = x0 + 0.05 + 0.3 * rand(B, 1, 1, k)
        y1 = y0 + 0.05 + 0.3 * rand(B, 1, 1, k)
        return (x >= x0) & (x < x1) & (y >= y0) & (y < y1)

    tex = box(TEXTURES).any(dim=-1, keepdim=True)
    img = img + tex * (60 * (rand(B, H, W, C) - 0.5))
    rects = box(RECTS)
    for i in range(RECTS):
        img = torch.where(rects[..., i:i + 1], 255 * rand(B, 1, 1, C), img)
    cx, cy = rand(B, 1, 1, ELLIPSES), rand(B, 1, 1, ELLIPSES)
    rx = 0.03 + 0.15 * rand(B, 1, 1, ELLIPSES)
    ry = 0.03 + 0.15 * rand(B, 1, 1, ELLIPSES)
    ell = ((x - cx) / rx) ** 2 + ((y - cy) / ry) ** 2 < 1
    for i in range(ELLIPSES):
        img = torch.where(ell[..., i:i + 1], 255 * rand(B, 1, 1, C), img)
    return img.round_().clamp_(0, 255).to(torch.uint8)


def photos(seed: int, count: int, H: int, W: int, C: int = 3,
           device="cuda", chunk: int = 32) -> np.ndarray:
    """(count, H, W, C) u8 host images from `seed`, made on `device`
    `chunk` images at a time."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    out = np.empty((count, H, W, C), np.uint8)
    for i in range(0, count, chunk):
        j = min(count, i + chunk)
        torch.from_numpy(out[i:j]).copy_(_batch(g, j - i, H, W, C, dev))
    return out
