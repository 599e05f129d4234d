"""Top-level one-call API — the analog of the plugin's render() entry point
(`src/render.c:327-419`), counterpart of `dct_carver_tpu/api.py`.
"""

from __future__ import annotations

import numpy as np

from .models.carver import Carver, CarveResult
from .utils.config import CarverConfig

__all__ = ["carve", "CarveResult", "CarverConfig"]


def carve(image, seams_number: int, *, blocksize: int = 8,
          edges: float = 0.0, textures: float = 1.0,
          vertically: bool = False, output_energy: bool = False,
          output_seams: bool = False, device=None,
          **framework_knobs) -> CarveResult:
    """Retarget `image` by `seams_number` seams (signed: <0 removes, >0
    inserts; `vertically=True` changes the HEIGHT — src/render.c:358-364).

    Defaults mirror the plugin's (src/main.c:30-40).  `device`: where the
    carve runs (default: the first CUDA card, else the CPU).  Only the
    single-image route is ported: a (B, H, W[, C]) stack raises.
    """
    image = np.asarray(image)
    if image.ndim == 4:
        raise NotImplementedError(
            "image stacks (the batch route) are not ported yet (ROADMAP "
            "Queue 1 item 8)")
    cfg = CarverConfig(
        edges=edges, textures=textures, blocksize=blocksize,
        seams_number=seams_number, vertically=vertically,
        output_energy=output_energy, output_seams=output_seams,
        **framework_knobs,
    )
    carver = Carver(image, cfg, device=device)
    h, w = image.shape[:2]
    if seams_number == 0:
        return CarveResult(
            image=image.copy(),
            visibility_map=(np.zeros((h, w), np.int32) if output_seams
                            else None),
            energy_image=(carver.energy_image() if output_energy else None),
        )
    if vertically:
        return carver.resize(w, h + seams_number)
    return carver.resize(w + seams_number, h)
