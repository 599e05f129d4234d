"""Precompute-once / slide-many retargeting — the interactive-dialog
capability (`src/interface.c:37-154`): liblqr computes ±N seams once
(`interface.c:131-135`), then any width within the range is a cheap replay
(`callback_resize_slider`, `interface.c:647-670`).

Counterpart of `dct_carver_tpu/models/retarget.py`: carve N seams once on
the device (`ops/carve.py::carve_n_seams`, the kernels' graphed seam step on
a card) to get the ordered visibility map; "sliding" to width w0−s (or
w0+s) is then one gather from the original image kept on the device, with
the vmap masked to `vmap <= s` — O(H·W) with no DP: `reconstruct_removed`'s
stable argsort to shrink, `reconstruct_enlarged` to enlarge.  The result is
copied to the host once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import carve as carve_ops
from ..ops.energy import to_luma
from ..utils.config import CarverConfig
from ..utils.placement import resolve_device

__all__ = ["InteractiveRetargeter"]


class InteractiveRetargeter:
    """Precompute ±`max_seams` once; then `at_width(w)` is gather-only (the
    `interface.c:647-670` slider semantics).  `vertical=True` retargets
    the height (`at_width` then takes a height)."""

    def __init__(self, image, max_seams: int,
                 config: CarverConfig | None = None, vertical: bool = False,
                 *, device=None, **overrides):
        """`device`: where the precompute runs and the image stays (default:
        the first CUDA card; raises when there is none and the CPU was not
        asked for).  `parallel=` is accepted and ignored, as in the JAX
        package: the precompute runs on `device` alone."""
        if config is None:
            config = CarverConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.vertical = vertical
        self.device = resolve_device(device)
        img = np.asarray(image)
        if vertical:
            img = np.swapaxes(img, 0, 1)
        self._h, self._w = img.shape[:2]
        self.max_seams = int(max_seams)
        if self.max_seams >= self._w:
            raise ValueError("max_seams must be < width")
        # a copy only where the array is strided or read-only
        self._img = torch.from_numpy(
            np.require(img, requirements=("C", "W"))).to(self.device)
        state = carve_ops.carve_n_seams(
            to_luma(self._img, config.luma), self.max_seams,
            config.blocksize, config.edges, config.textures,
            strip_update=config.strip_update, use_pallas=config.use_pallas,
            delta_x=config.delta_x, rigidity=config.rigidity,
            tie=config.tie, energy_fn=config.energy_function)
        self._vmap = state.vmap  # ordered seams, original coordinates

    @property
    def visibility_map(self) -> np.ndarray:
        return self._vmap.to("cpu", copy=True).numpy()

    def at_width(self, new_width: int) -> np.ndarray:
        """Retargeted image at any width in [w0-max_seams, w0+max_seams]."""
        s = new_width - self._w
        if abs(s) > self.max_seams:
            raise ValueError(
                f"width {new_width} outside precomputed range "
                f"±{self.max_seams} of {self._w}"
            )
        if s == 0:  # never the retargeter's own buffer
            out = self._img.to("cpu", copy=True)
        else:
            # masked vmap: only the first |s| seams apply
            vm = torch.where(self._vmap <= abs(s), self._vmap, 0)
            if s < 0:
                out = carve_ops.reconstruct_removed(self._img, vm, -s)
            else:
                out = carve_ops.reconstruct_enlarged(self._img, vm, s)
        out = out.cpu().numpy()
        if self.vertical:
            out = np.swapaxes(out, 0, 1)
        return out

    def at_delta(self, s: int) -> np.ndarray:
        return self.at_width(self._w + s)
