"""The device mesh, and the batch route: carve a stack of same-size images,
split over devices.

Counterpart of `dct_carver_tpu/parallel/mesh.py` (`make_mesh` :26,
`batch_carve_states` :40, `carve_batch` :69), the route of BASELINE config
4.  A mesh here is an ordered list of torch devices (`make_mesh`); the
spatial route (`parallel/spatial.py`) puts one column shard on each entry,
and an entry may repeat, so several shards can share one card.  JAX `vmap`s the
single-image carve over the batch and shards the batch over a device mesh.
Here the carve loop itself takes the leading B (`ops/carve.py`), so each
seam step is one launch per kernel for the whole batch on a device.

With no devices named the batch goes over every visible card, as JAX's
default mesh takes every device (`models/carver.py::default_mesh`).  Over
several devices the batch is cut into contiguous chunks, one per device,
and the results are joined in order on the first device.  Every chunk's
copy to its card is queued before any carve (a copy between cards runs
on the source card's stream, behind what is queued there), then the host
launches one chunk's carve after the other; no call in the carve waits
for its device, so the devices run at the same time.  There is no
padding: JAX pads the batch to a multiple of the mesh only to shard it
evenly.
"""

from __future__ import annotations

import torch

from ..models.carver import (NO_CARD, default_mesh, resolve_device,
                             resolve_placement)
from ..ops import carve as carve_ops
from ..ops.energy import to_luma
from ..ops.energy_fn import resolve_energy
from ..utils.profiling import span

__all__ = ["make_mesh", "carve_batch", "batch_carve_states"]


def make_mesh(n_devices: int | None = None,
              devices=None) -> list[torch.device]:
    """The ordered devices of a 1-D mesh: `devices` when given, else the
    first `n_devices` visible CUDA cards (default: all of them).  Entries
    may repeat: `["cuda:0"] * 4` is four shards on one card, and
    `["cpu"] * 8` the CPU counterpart of the JAX tests' 8-device mesh.
    Raises when no device is named and no card is visible."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(NO_CARD)
        devices = [f"cuda:{i}" for i in range(count)]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    for d in devices:
        resolve_device(d)
    return devices


def batch_carve_states(images: torch.Tensor, n_seams: int, blocksize: int,
                       edges, textures, strip_update: bool = True,
                       luma_mode: str = "bt709", energy_fn=None,
                       delta_x: int = 1, rigidity: float = 0.0,
                       tie: str = "leftmost",
                       use_pallas: bool = True) -> carve_ops.CarveState:
    """Carve every image of a (B, H, W[, C]) tensor on its device; returns
    the batched CarveState ((B, H, W) tensors, one shared `width`).
    `energy_fn`: a plugged `EnergyFunction`, or None for the DCT energy."""
    if images.ndim not in (3, 4):
        raise ValueError(f"images must be a (B, H, W[, C]) stack, got "
                         f"{tuple(images.shape)}")
    with span("carve.luma"):
        lumas = to_luma(images, luma_mode, stack=True)
    return carve_ops.carve_n_seams(
        lumas, n_seams, blocksize, edges, textures, strip_update=strip_update,
        use_pallas=use_pallas, delta_x=delta_x, rigidity=rigidity, tie=tie,
        energy_fn=energy_fn)


def _carve_chunk(chunk: torch.Tensor, dev: torch.device, n_seams: int,
                 reconstruct: bool, **knobs):
    """One device's chunk of a batch carve, on `dev`: (vmaps, carved or
    None)."""
    with span("carve.copy_in"):
        chunk = chunk.to(dev).contiguous()
    vmap = batch_carve_states(chunk, n_seams, **knobs).vmap
    if not reconstruct:
        return vmap, None
    with span("carve.reconstruct"):
        return vmap, carve_ops.reconstruct_removed(chunk, vmap, n_seams)


def _join(parts: list[torch.Tensor], home: torch.device) -> torch.Tensor:
    with span("batch.join"):
        if len(parts) == 1:
            return parts[0].to(home)
        return torch.cat([p.to(home) for p in parts])


def carve_batch(images, n_seams: int, *, blocksize: int = 8,
                edges: float = 0.0, textures: float = 1.0, devices=None,
                strip_update: bool = True, reconstruct: bool = True,
                energy=None, luma: str = "bt709", delta_x: int = 1,
                rigidity: float = 0.0, tie: str = "leftmost",
                use_pallas: bool = True):
    """Remove `n_seams` vertical seams from every image of a batch (config
    4 of BASELINE.md: 1024 x 1-Mpix images, 128 seams).

    images: (B, H, W[, C]) u8/float, a numpy array or a tensor.  `devices`:
    the torch devices to split the batch over (default: every visible CUDA
    card, `models/carver.py::default_mesh`; pass `["cpu"]` to run on the
    CPU).  Returns (carved (B, H, W - n_seams[, C]) | None, vmaps (B, H, W)
    int32), tensors on the first device.  `energy`: None/'dct', a builtin
    name or an `EnergyFunction`.
    """
    energy_fn = resolve_energy(energy)
    device, mesh = resolve_placement(None, devices or None)
    devices = mesh or default_mesh(device)
    images = torch.as_tensor(images)
    if images.ndim not in (3, 4) or not len(images):
        raise ValueError(f"images must be a (B, H, W[, C]) stack of B >= 1, "
                         f"got {tuple(images.shape)}")
    chunks = torch.tensor_split(images, len(devices))
    if images.device.type == "cuda":  # every copy queued before any carve
        with span("carve.copy_in"):
            chunks = [c.to(dev) for dev, c in zip(devices, chunks)]
    outs, vmaps = [], []
    for dev, chunk in zip(devices, chunks):
        if not len(chunk):
            continue
        with span("batch.chunk"):
            vmap, out = _carve_chunk(
                chunk, dev, n_seams, reconstruct, blocksize=blocksize,
                edges=edges, textures=textures, strip_update=strip_update,
                luma_mode=luma, energy_fn=energy_fn, delta_x=delta_x,
                rigidity=rigidity, tie=tie, use_pallas=use_pallas)
        vmaps.append(vmap)
        outs.append(out)
    vm = _join(vmaps, devices[0])
    return (_join(outs, devices[0]) if reconstruct else None), vm
