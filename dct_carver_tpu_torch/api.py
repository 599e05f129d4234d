"""Top-level one-call API — the analog of the plugin's render() entry point
(`src/render.c:327-419`), counterpart of `dct_carver_tpu/api.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.carver import (Carver, CarveResult, default_mesh,
                            resolve_placement)
from .utils.config import CarverConfig
from .utils.profiling import span

__all__ = ["carve", "CarveResult", "CarverConfig"]


def carve(image, seams_number: int, *, blocksize: int = 8,
          edges: float = 0.0, textures: float = 1.0,
          vertically: bool = False, output_energy: bool = False,
          output_seams: bool = False, device=None, devices=None,
          **framework_knobs) -> CarveResult:
    """Retarget `image` by `seams_number` seams (signed: <0 removes, >0
    inserts; `vertically=True` changes the HEIGHT — src/render.c:358-364).

    Defaults mirror the plugin's (src/main.c:30-40).  `device`: where the
    carve runs (default: the first CUDA card; with no card visible it
    raises unless `device="cpu"` asks for the CPU).  `devices`: the mesh
    (`parallel/mesh.py::make_mesh`, e.g. `["cuda:0"] * 4`): the spatial
    route's shards, the batch route's chunks; `device` then defaults to its
    first entry and may not name another.  With no `devices` the mesh of
    both routes is every visible card for `device` None or "cuda", else
    `[device]` (`models/carver.py::default_mesh`).

    Routing (`parallel=`): "batch" carves an image STACK — a (B, H, W[, C])
    array, whose result fields come back stacked over B — with one launch
    per kernel and seam for the whole stack; "auto" takes the batch route
    for a 4-D input and otherwise the spatial route when more than one card
    is visible (or `devices` names more than one), else the single-image
    route; "spatial" column-shards one image over the mesh
    (`parallel/spatial.py`, BASELINE config 5).  Every knob keeps its
    single-image meaning on every route.
    """
    image = np.asarray(image)
    cfg = CarverConfig(
        edges=edges, textures=textures, blocksize=blocksize,
        seams_number=seams_number, vertically=vertically,
        output_energy=output_energy, output_seams=output_seams,
        **framework_knobs,
    )
    if cfg.parallel == "batch" or (cfg.parallel == "auto" and image.ndim == 4):
        with span("carve.stack"):
            return _carve_stack(image, seams_number, cfg, device, devices)
    carver = Carver(image, cfg, device=device, devices=devices)
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


def _stack_energy_u8(images: torch.Tensor, cfg: CarverConfig) -> np.ndarray:
    """Each image's full energy (the configured energy's own map), min-max
    normalized to u8 on its own."""
    from .ops.carve import full_energy_map
    from .ops.energy import normalize_to_u8, to_luma

    with span("carve.energy_export"):
        e = full_energy_map(to_luma(images, cfg.luma, stack=True),
                            cfg.blocksize, cfg.edges, cfg.textures,
                            use_pallas=cfg.use_pallas,
                            energy_fn=cfg.energy_function)
        return normalize_to_u8(e).cpu().numpy()


def _carve_stack(images: np.ndarray, seams_number: int, cfg: CarverConfig,
                 device, devices) -> CarveResult:
    """Carve of a (B, H, W[, C]) stack on `device`, or split over the mesh
    `devices` (`parallel.mesh` — BASELINE config 4), following JAX
    `api.py::_carve_stack` knob by knob.
    Every image is carved independently, exactly as `render()` treats each
    invocation (src/render.c:327); results stack over B.

    One deliberate deviation: with `seams_number == 0` and
    `output_energy=True` the energies are returned, where JAX returns None
    (ROADMAP Queue 3)."""
    from .ops.carve import reconstruct_enlarged
    from .parallel.mesh import carve_batch

    if images.ndim not in (3, 4):
        raise ValueError(
            f"parallel='batch' needs a (B, H, W[, C]) stack; got shape "
            f"{images.shape}")
    if cfg.vertically:
        images = np.swapaxes(images, 1, 2)
    B, h0, w0 = images.shape[:3]
    n = abs(seams_number)
    if n >= w0:
        raise ValueError(
            f"cannot change dimension by {seams_number}: images are "
            f"{w0} wide")
    dev, mesh = resolve_placement(device, devices)
    # on the host: carve_batch copies each chunk straight to its card
    stack = torch.from_numpy(np.ascontiguousarray(images))
    energy = None
    if cfg.output_energy:
        # pre-carve energy export, per image (src/render.c:370-377 ordering)
        with span("carve.copy_in"):
            on_dev = stack.to(dev)
        energy = _stack_energy_u8(on_dev, cfg)
    kw = dict(blocksize=cfg.blocksize, edges=cfg.edges,
              textures=cfg.textures, devices=mesh or default_mesh(dev),
              strip_update=cfg.strip_update, energy=cfg.energy_function,
              luma=cfg.luma, delta_x=cfg.delta_x, rigidity=cfg.rigidity,
              tie=cfg.tie, use_pallas=cfg.use_pallas)
    if seams_number == 0:
        out, vmaps = images.copy(), np.zeros((B, h0, w0), np.int32)
    else:
        if seams_number < 0:
            out, vmaps = carve_batch(stack, n, **kw)
        else:
            _, vmaps = carve_batch(stack, n, reconstruct=False, **kw)
            with span("carve.copy_in"):
                on_dev = stack.to(vmaps.device)
            with span("carve.reconstruct"):
                out = reconstruct_enlarged(on_dev, vmaps, n)
        with span("carve.copy_out.image"):
            out = out.cpu().numpy()
        with span("carve.copy_out.vmap"):
            vmaps = vmaps.cpu().numpy()
    if not cfg.resize_canvas:
        # resize_canvas=FALSE analog (src/main.h:19), per image: removals
        # zero-fill the vacated region on the original canvas, enlargements
        # crop — the single-image route's semantics
        canvas = np.zeros((B, h0, w0) + out.shape[3:], out.dtype)
        w = min(w0, out.shape[2])
        canvas[:, :, :w] = out[:, :, :w]
        out = canvas
    if cfg.vertically:
        out = np.swapaxes(out, 1, 2)
        vmaps = np.swapaxes(vmaps, 1, 2)
        if energy is not None:
            energy = np.swapaxes(energy, 1, 2)
    return CarveResult(
        image=out,
        visibility_map=vmaps if cfg.output_seams else None,
        energy_image=energy,
    )
