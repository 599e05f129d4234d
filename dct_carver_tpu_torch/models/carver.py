"""The Carver — lifecycle object mirroring the liblqr carver the plugin drives.

Counterpart of `dct_carver_tpu/models/carver.py` (reference call surface
`src/render.c:286-325`):
    lqr_carver_new(buffer, w, h, bpp)        -> Carver(image, config)
    lqr_carver_set_energy_function(...)      -> config.energy
    lqr_carver_set_progress(...)             -> Carver(..., progress=...)
    lqr_carver_resize(w', h')                -> .resize(w', h')
    lqr_carver_get_energy_image(...)         -> .energy_image()
    lqr_vmap_get_data                        -> CarveResult.visibility_map

The image stays a host numpy array; each pass moves it to `device`, carves
there and brings the results back.  On the spatial route
(`parallel="spatial"`, `parallel/spatial.py`) the pass column-shards the
image over the mesh `devices` instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import carve as carve_ops
from ..ops.energy import normalize_to_u8, to_luma
from ..utils.config import CarverConfig
from ..utils.placement import default_mesh, resolve_placement
from ..utils.profiling import span

__all__ = ["Carver", "CarveResult"]


@dataclasses.dataclass
class CarveResult:
    """Outputs of one resize (render()'s outputs, src/main.c:79-105)."""
    image: np.ndarray                 # retargeted image (H', W'[, C])
    visibility_map: np.ndarray | None # int32 (H, W) original coords, or None
    energy_image: np.ndarray | None   # u8 normalized first-energy, or None


class Carver:
    """Seam carver over one image.  Width-wise carving is canonical; height
    retargeting transposes internally (src/render.c:358-364)."""

    def __init__(self, image, config: CarverConfig | None = None, *,
                 device=None, devices=None, progress=None,
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 0, resume_from: str | None = None,
                 **overrides):
        """`device`: where the carve runs (default: the first CUDA card;
        raises when there is none and the CPU was not asked for).
        `devices`: the mesh of the spatial route (`parallel/mesh.py::
        make_mesh`; `device` then defaults to its first entry and may not
        name another).  With no `devices` the mesh is every visible card
        for `device` None or "cuda", else `[device]`.  `progress` is a utils.progress.Progress (the analog of
        lqr_carver_set_progress, src/render.c:316); checkpoint_* /
        resume_from route the seam loop through
        utils.checkpoint.carve_resumable, or on the spatial route through
        its sharded checkpoints.  With bidirectional resizes they apply to
        the WIDTH pass (the first one)."""
        if config is None:
            config = CarverConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.progress = progress
        self._ckpt = (checkpoint_path, checkpoint_every, resume_from)
        self.device, self.devices = resolve_placement(device, devices)
        self._resolved_parallel()
        self.image = np.asarray(image)
        if self.image.ndim not in (2, 3):
            raise ValueError("image must be (H, W) or (H, W, C)")
        self._h, self._w = self.image.shape[:2]

    def _resolved_parallel(self) -> str:
        """The route for THIS carver (one image): "none" or "spatial".
        Counterpart of the JAX `Carver._resolved_parallel`, whose "auto"
        picks the spatial route for any image whenever more than one device
        is visible (ROADMAP Queue 3); the port mirrors it."""
        par = self.config.parallel
        if par == "batch":
            raise ValueError(
                "parallel='batch' applies to image stacks — pass a "
                "(B, H, W[, C]) array to api.carve, or use "
                "parallel.mesh.carve_batch")
        if par == "auto":
            par = "spatial" if len(self._mesh()) > 1 else "none"
        return par

    def _mesh(self) -> list:
        return (self.devices if self.devices is not None
                else default_mesh(self.device))

    def _to_device(self, img: np.ndarray, device=None) -> torch.Tensor:
        # a copy on the host only where the array is strided (a height
        # pass's transposition) or read-only (Pillow's)
        with span("carve.copy_in"):
            return torch.from_numpy(np.require(img, requirements=("C", "W"))
                                    ).to(device or self.device)

    def _energy_u8(self, luma: torch.Tensor, center: str = "carve",
                   energy_fn=None):
        cfg = self.config
        with span("carve.energy_export"):
            e = carve_ops.full_energy_map(luma, cfg.blocksize, cfg.edges,
                                          cfg.textures, center=center,
                                          use_pallas=cfg.use_pallas,
                                          energy_fn=energy_fn)
            return normalize_to_u8(e).cpu().numpy()

    # -- lqr_carver_get_energy_image (src/render.c:175-202) ------------------
    def energy_image(self, *, vertically: bool | None = None) -> np.ndarray:
        """Full-image energy (the configured energy's own), min-max
        normalized to u8 grayscale."""
        cfg = self.config
        if vertically is None:
            vertically = cfg.vertically
        img = np.swapaxes(self.image, 0, 1) if vertically else self.image
        out = self._energy_u8(to_luma(self._to_device(img), cfg.luma),
                              energy_fn=cfg.energy_function)
        return np.swapaxes(out, 0, 1) if vertically else out

    # -- dct_energy_preview (src/render.c:421-479): BT.601-studio luma
    #    (render.h:5) and the preview window centering (dct.h:8-9); the DCT
    #    energy whatever energy is plugged, as in the JAX package
    def energy_preview(self) -> np.ndarray:
        luma = to_luma(self._to_device(self.image), "bt601_studio")
        return self._energy_u8(luma, center="preview")

    # -- lqr_carver_resize (src/render.c:377) ---------------------------------
    def resize(self, new_width: int, new_height: int) -> CarveResult:
        """Retarget to (new_width, new_height): the width pass first, then
        the height pass on its result (liblqr's order)."""
        with span("carve.resize"):
            result_img = self.image
            vmap = None
            energy = None
            if new_width != self._w:
                with span("carve.pass"):
                    result_img, vmap, energy = self._carve_axis(
                        result_img, new_width - self._w, transpose=False)
            if new_height != self._h:
                with span("carve.pass"):
                    result_img, vmap2, energy2 = self._carve_axis(
                        result_img, new_height - self._h, transpose=True)
                if vmap is None:
                    vmap, energy = vmap2, energy2
            if not self.config.resize_canvas:
                # src/main.h:19 resize_canvas=FALSE: the retargeted layer
                # sits at the top-left of the original canvas; shrunk
                # dimensions zero-fill, grown ones crop
                canvas = np.zeros((self._h, self._w) + result_img.shape[2:],
                                  result_img.dtype)
                h = min(self._h, result_img.shape[0])
                w = min(self._w, result_img.shape[1])
                canvas[:h, :w] = result_img[:h, :w]
                result_img = canvas
        return CarveResult(
            image=result_img,
            visibility_map=vmap if self.config.output_seams else None,
            energy_image=energy if self.config.output_energy else None,
        )

    # -- the single-axis carve (vertical seams over a possibly-transposed img)
    def _carve_axis(self, image: np.ndarray, delta: int, transpose: bool):
        cfg = self.config
        img = np.swapaxes(image, 0, 1) if transpose else image
        n = abs(delta)
        if n >= img.shape[1]:
            raise ValueError(
                f"cannot change dimension by {delta}: image is "
                f"{img.shape[1]} wide")
        if self._resolved_parallel() == "spatial":
            return self._carve_axis_spatial(img, delta, transpose)
        dev_img = self._to_device(img)
        with span("carve.luma"):
            luma = to_luma(dev_img, cfg.luma)
        ckpt_path, ckpt_every, resume = self._ckpt
        if transpose or (self.progress is None and ckpt_path is None
                         and resume is None):
            state = carve_ops.carve_n_seams(
                luma, n, cfg.blocksize, cfg.edges, cfg.textures,
                strip_update=cfg.strip_update, use_pallas=cfg.use_pallas,
                delta_x=cfg.delta_x, rigidity=cfg.rigidity, tie=cfg.tie,
                energy_fn=cfg.energy_function)
        else:
            from ..utils.checkpoint import carve_resumable

            state = carve_resumable(
                luma, n, cfg, checkpoint_path=ckpt_path,
                checkpoint_every=ckpt_every, resume_from=resume,
                progress=self.progress, device=self.device)
        with span("carve.reconstruct"):
            if delta < 0:
                out = carve_ops.reconstruct_removed(dev_img, state.vmap, n)
            else:
                out = carve_ops.reconstruct_enlarged(dev_img, state.vmap, n)
        with span("carve.copy_out.image"):
            out = out.cpu().numpy()
        with span("carve.copy_out.vmap"):
            vmap_np = state.vmap.cpu().numpy()
        # the reference exports the PRE-carve energy (display_carver_energy
        # runs before lqr_carver_resize, src/render.c:370-377)
        energy_np = (self._energy_u8(luma, energy_fn=cfg.energy_function)
                     if cfg.output_energy else None)
        if transpose:
            out = np.swapaxes(out, 0, 1)
            vmap_np = np.swapaxes(vmap_np, 0, 1)
            if energy_np is not None:
                energy_np = np.swapaxes(energy_np, 0, 1)
        return out, vmap_np, energy_np

    # -- the mesh-sharded single-image route (parallel/spatial.py: the same
    #    seams as the single-device route)
    def _carve_axis_spatial(self, img: np.ndarray, delta: int,
                            transpose: bool):
        from ..parallel.spatial import (spatial_carve_n_seams,
                                        spatial_enlarge_n_seams)

        cfg = self.config
        n = abs(delta)
        mesh = self._mesh()
        dev_img = self._to_device(img, mesh[0])
        with span("carve.luma"):
            luma = to_luma(dev_img, cfg.luma)
        ckpt_path, ckpt_every, resume = self._ckpt
        if transpose:  # as on one device, checkpoints and progress cover
            ckpt_path = resume = None  # the width pass (the first) only
        common = dict(
            blocksize=cfg.blocksize, edges=cfg.edges, textures=cfg.textures,
            devices=mesh, strip_update=cfg.strip_update,
            use_pallas=cfg.use_pallas, delta_x=cfg.delta_x,
            rigidity=cfg.rigidity, energy=cfg.energy_function, tie=cfg.tie,
            progress=None if transpose else self.progress,
            chunk=ckpt_every if (ckpt_path or resume) else 0,
            checkpoint_dir=ckpt_path, resume_from=resume,
        )
        if delta < 0:
            res = spatial_carve_n_seams(luma, n, image=dev_img, **common)
            out = res.image[:, :img.shape[1] - n]
        else:
            res = spatial_enlarge_n_seams(luma, n, dev_img, **common)
            out = res.image
        with span("carve.copy_out.image"):
            out = out.cpu().numpy()
        with span("carve.copy_out.vmap"):
            vmap_np = res.vmap.cpu().numpy()
        # the pre-carve energy export, unsharded as in the JAX package
        # (display_carver_energy runs before the resize, src/render.c:
        # 370-377)
        energy_np = (self._energy_u8(luma, energy_fn=cfg.energy_function)
                     if cfg.output_energy else None)
        if transpose:
            out = np.swapaxes(out, 0, 1)
            vmap_np = np.swapaxes(vmap_np, 0, 1)
            if energy_np is not None:
                energy_np = np.swapaxes(energy_np, 0, 1)
        return out, vmap_np, energy_np
