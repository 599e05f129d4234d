"""A multi-device dry run of both parallel routes on tiny shapes.

Counterpart of the JAX package's `__graft_entry__.py::dryrun_multichip`:
the batch route splits a stack of images over the mesh (no exchange
between devices), and the spatial route column-shards one image over it
(halo exchanges, the blocked DP frontier, the backtrack's reductions, the
sharded strip update and compaction), each held against the
single-device carve.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.carve import carve_n_seams, reconstruct_enlarged, \
    reconstruct_removed
from ..ops.energy import to_luma
from .mesh import carve_batch, make_mesh
from .spatial import spatial_carve_n_seams, spatial_enlarge_n_seams

__all__ = ["dryrun_multichip"]


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _one_per_row(vmap: np.ndarray, n_seams: int) -> bool:
    return all(((vmap == k).sum(axis=-1) == 1).all()
               for k in range(1, n_seams + 1))


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run both routes over a mesh of `n_devices` entries, on the JAX
    function's shapes, and raise AssertionError where a result differs from
    the single-device carve on the mesh's first device.

    `devices`: the mesh (default the first `n_devices` visible cards; e.g.
    `["cuda:0"] * 4` on one card, `["cpu"] * n` on the CPU).  The cases: a
    batch of 2n 32 x 40 RGB images, 2 seams each, with its reconstruct; a
    24 x 8n RGB image carved by 2 seams on the spatial route with K = 8,
    carrying the image; its enlargement by 2 seams; `delta_x=2,
    rigidity=0.5`; and the plain spatial path (`use_pallas=False`) against
    the kernels'.  Returns the numpy outputs: `batch_vmap`, `batch_image`,
    `luma`, `spatial_vmap`, `spatial_image`, `enlarged_image`,
    `delta_vmap`."""
    if devices is None:
        devices = make_mesh()
        if len(devices) < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}): only "
                               f"{len(devices)} cards are visible")
    devices = make_mesh(n_devices, devices=devices)
    _require(len(devices) == n_devices,
             f"a mesh of {n_devices} devices, got {devices}")
    home = devices[0]
    rng = np.random.default_rng(0)
    n_seams = 2

    # (a) the batch route: per-image independence, no exchange
    batch = 2 * n_devices
    images = rng.integers(0, 256, size=(batch, 32, 40, 3), dtype=np.uint8)
    out, vmaps = carve_batch(images, n_seams, devices=devices)
    _require(tuple(out.shape) == (batch, 32, 40 - n_seams, 3),
             f"batch output shape {tuple(out.shape)}")
    one_out, one_vm = carve_batch(images, n_seams, devices=[home])
    _require(torch.equal(vmaps, one_vm) and torch.equal(out, one_out),
             "batch route == one device")
    _require(_one_per_row(vmaps.cpu().numpy(), n_seams),
             "one pixel a row a seam (batch)")

    # (b) the spatial route: one image column-sharded over every entry,
    # the RGB image carried through the sharded compaction
    H, W = 24, n_devices * 8
    img = torch.from_numpy(rng.integers(0, 256, size=(H, W, 3),
                                        dtype=np.uint8)).to(home)
    luma = to_luma(img)
    res = spatial_carve_n_seams(luma, n_seams, devices=devices,
                                frontier_block=8, image=img)
    _require(res.width == W - n_seams, f"spatial width {res.width}")
    ref = carve_n_seams(luma, n_seams, 8, 0.0, 1.0, strip_update=False)
    _require(torch.equal(res.vmap, ref.vmap), "spatial vmap == one device")
    _require(_one_per_row(res.vmap.cpu().numpy(), n_seams),
             "one pixel a row a seam (spatial)")
    rec = res.image[:, :W - n_seams]
    _require(torch.equal(rec, reconstruct_removed(img, ref.vmap, n_seams)),
             "spatial image == reconstruct_removed")

    # (c) enlargement on the mesh: the sharded insertion
    enl = spatial_enlarge_n_seams(luma, n_seams, img, devices=devices,
                                  frontier_block=8, strip_update=False)
    _require(enl.width == W + n_seams, f"enlarged width {enl.width}")
    _require(torch.equal(enl.image,
                         reconstruct_enlarged(img, ref.vmap, n_seams)),
             "spatial enlargement == reconstruct_enlarged")

    # (d) the generalized DP stays seam-exact on the mesh
    res_d = spatial_carve_n_seams(luma, n_seams, devices=devices, delta_x=2,
                                  rigidity=0.5, frontier_block=8,
                                  strip_update=False)
    ref_d = carve_n_seams(luma, n_seams, 8, 0.0, 1.0, strip_update=False,
                          delta_x=2, rigidity=0.5)
    _require(torch.equal(res_d.vmap, ref_d.vmap),
             "delta_x=2, rigidity=0.5 vmap == one device")

    # (e) the kernels (on CUDA tensors) against the plain spatial path
    res_p = spatial_carve_n_seams(luma, n_seams, devices=devices,
                                  frontier_block=8, use_pallas=False)
    _require(torch.equal(res_p.vmap, res.vmap),
             "plain spatial path == kernels")

    return {"batch_vmap": vmaps.cpu().numpy(),
            "batch_image": out.cpu().numpy(),
            "luma": luma.cpu().numpy(),
            "spatial_vmap": res.vmap.cpu().numpy(),
            "spatial_image": rec.cpu().numpy(),
            "enlarged_image": enl.image.cpu().numpy(),
            "delta_vmap": res_d.vmap.cpu().numpy()}
