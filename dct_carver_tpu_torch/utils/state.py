"""The carve state carried between the two packages.

The system has no weights: what carries over is the carve state and the
DCT taps (`ops/dct.py::_dct_matrix_np`, the same in both packages).  These
helpers turn a JAX `CarveState` given as numpy arrays (`luma`, `origcol`,
`vmap`, `width`, `energy`) into the port's `CarveState` on a device, and
back, so a carve can start in one package and go on in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.carve import CarveState

__all__ = ["state_from_numpy", "state_to_numpy"]


def state_from_numpy(arrays, device="cpu") -> CarveState:
    """Mapping of numpy arrays -> CarveState on `device` (copies).  `luma`
    keeps its float dtype; `width` may be a 0-d array or an int."""
    def put(name, dtype=None):
        return torch.as_tensor(np.array(arrays[name]), dtype=dtype,
                               device=device)

    luma = put("luma")
    if not luma.dtype.is_floating_point or luma.ndim != 2:
        raise ValueError("luma must be a (H, W) float array")
    state = CarveState(
        luma=luma,
        origcol=put("origcol", torch.int32),
        vmap=put("vmap", torch.int32),
        width=int(np.asarray(arrays["width"])),
        energy=put("energy", torch.float32),
    )
    for name in ("origcol", "vmap", "energy"):
        if getattr(state, name).shape != luma.shape:
            raise ValueError(f"{name} must have luma's shape {tuple(luma.shape)}")
    return state


def state_to_numpy(state: CarveState) -> dict:
    """CarveState -> dict of numpy arrays (`width` as a 0-d int32 array)."""
    return {
        "luma": state.luma.cpu().numpy(),
        "origcol": state.origcol.cpu().numpy(),
        "vmap": state.vmap.cpu().numpy(),
        "width": np.asarray(state.width, np.int32),
        "energy": state.energy.cpu().numpy(),
    }
