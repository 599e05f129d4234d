"""The carve state carried between the two packages.

The system has no weights: what carries over is the carve state and the
DCT taps (`ops/dct.py::_dct_matrix_np`, the same in both packages).  These
helpers turn a JAX `CarveState` given as numpy arrays (`luma`, `origcol`,
`vmap`, `width`, `energy`) into the port's `CarveState` on a device, and
back, so a carve can start in one package and go on in the other.  A
batched state (JAX `parallel/mesh.py::batch_carve_states`: (B, H, W) arrays
and a (B,) `width`) carries over too; the port's batch shares one width, so
every image's must be equal.

The spatial route's state carries over the same way
(`spatial_state_from_numpy` / `spatial_state_to_numpy`): the leaves of a JAX
`parallel/spatial.py::SpatialCarveState` as whole (H, W) numpy arrays, W
the mesh-padded buffer width, and the port's sharded state on a mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.carve import CarveState
from .placement import resolve_device

__all__ = ["state_from_numpy", "state_to_numpy",
           "spatial_state_from_numpy", "spatial_state_to_numpy"]


def state_from_numpy(arrays, device=None) -> CarveState:
    """Mapping of numpy arrays -> CarveState on `device` (copies; default
    the first CUDA card, `utils/placement.py::resolve_device`, as JAX's
    `jnp.asarray` puts it on the default device).  `luma` keeps its float
    dtype and is (H, W), or (B, H, W) for a batch; `width` is an int or a
    0-d array, or for a batch a (B,) array of equal widths."""
    device = resolve_device(device)

    def put(name, dtype=None):
        return torch.as_tensor(np.array(arrays[name]), dtype=dtype,
                               device=device)

    luma = put("luma")
    if not luma.dtype.is_floating_point or luma.ndim not in (2, 3):
        raise ValueError("luma must be a (H, W) or (B, H, W) float array")
    widths = np.unique(np.asarray(arrays["width"]))
    if widths.size != 1:
        raise ValueError(f"the images of a batch must share one width, got "
                         f"{widths.tolist()}")
    state = CarveState(
        luma=luma,
        origcol=put("origcol", torch.int32),
        vmap=put("vmap", torch.int32),
        width=int(widths[0]),
        energy=put("energy", torch.float32),
    )
    for name in ("origcol", "vmap", "energy"):
        if getattr(state, name).shape != luma.shape:
            raise ValueError(f"{name} must have luma's shape {tuple(luma.shape)}")
    return state


def state_to_numpy(state: CarveState) -> dict:
    """CarveState -> dict of numpy arrays (`width` as a 0-d int32 array,
    or a (B,) one for a batched state, as JAX's)."""
    width = np.asarray(state.width, np.int32)
    if state.luma.ndim == 3:
        width = np.full(state.luma.shape[0], width, np.int32)
    return {
        "luma": state.luma.cpu().numpy(),
        "origcol": state.origcol.cpu().numpy(),
        "vmap": state.vmap.cpu().numpy(),
        "width": width,
        "energy": state.energy.cpu().numpy(),
    }


def spatial_state_from_numpy(arrays, devices):
    """Mapping of numpy arrays (the JAX `SpatialCarveState` leaves: luma,
    image, origcol, vmap, energy as (H, W[, C]) arrays, width) -> (the
    port's `SpatialCarveState`, its `ShardMesh`) over the mesh `devices`,
    which must divide W.  JAX's (1, shards) image placeholder, or a missing
    image, means no carried image."""
    from ..parallel.mesh import make_mesh
    from ..parallel.shards import ShardMesh
    from ..parallel.spatial import SpatialCarveState

    luma = np.asarray(arrays["luma"])
    if luma.ndim != 2 or not np.issubdtype(luma.dtype, np.floating):
        raise ValueError("luma must be a (H, W) float array")
    mesh = ShardMesh(make_mesh(devices=devices), luma.shape[1])

    def put(name, dtype=None):
        a = torch.as_tensor(np.array(arrays[name]), dtype=dtype)
        if a.shape[:2] != luma.shape:
            raise ValueError(f"{name} must have luma's shape {luma.shape}")
        return mesh.split(a)

    image = arrays.get("image")
    with_image = image is not None and np.shape(image)[:2] == luma.shape
    state = SpatialCarveState(
        luma=put("luma"), image=put("image") if with_image else None,
        origcol=put("origcol", torch.int32), vmap=put("vmap", torch.int32),
        energy=put("energy", torch.float32),
        width=int(np.asarray(arrays["width"])))
    return state, mesh


def spatial_state_to_numpy(state, mesh) -> dict:
    """The port's sharded state -> dict of whole numpy arrays with the JAX
    leaf names (`width` a 0-d int32 array; no carried image gives JAX's
    (1, shards) placeholder)."""
    out = {name: mesh.join(getattr(state, name)).cpu().numpy()
           for name in ("luma", "origcol", "vmap", "energy")}
    out["image"] = (mesh.join(state.image).cpu().numpy()
                    if state.image is not None
                    else np.zeros((1, mesh.size), out["luma"].dtype))
    out["width"] = np.asarray(state.width, np.int32)
    return out
