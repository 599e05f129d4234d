"""Where a carve runs, for every layer: the device, the mesh (an ordered
list of torch devices, `make_mesh`, also `parallel/mesh.py`'s under its JAX
name), and `NO_CARD`, which every default raises with no card visible.
"""

from __future__ import annotations

import torch

__all__ = ["NO_CARD", "default_device", "resolve_device", "resolve_card",
           "resolve_placement", "default_mesh", "make_mesh"]

NO_CARD = ("no CUDA device is visible: pass device='cpu' (devices=['cpu'] "
           "for a mesh, --device cpu on the command line) to run on the CPU")


def default_device() -> torch.device:
    """The first CUDA card.  Raises when none is visible: the port runs on
    the card unless the caller asks for the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(NO_CARD)
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """`device` as a torch device, `default_device()` for None; a CUDA
    device raises when no card is visible."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(NO_CARD)
    return device


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


def resolve_placement(device=None, devices=None):
    """The one placement of a carve on every route: (device, mesh).  A given
    `devices` is the mesh and `device` defaults to its first entry; another
    `device` raises.  Else the mesh is None (`default_mesh`)."""
    if devices is None:
        return resolve_device(device), None
    mesh = make_mesh(devices=devices)
    if device is None:
        return mesh[0], mesh
    device = resolve_device(device)
    if resolve_card(device) != resolve_card(mesh[0]):
        raise ValueError(f"device {device} is not the mesh's first device "
                         f"{mesh[0]}: name one placement")
    return device, mesh


def default_mesh(device: torch.device) -> list:
    """The mesh when none is named: every visible card for a bare "cuda",
    else the one device that `device` names."""
    if device.type == "cuda" and device.index is None:
        return make_mesh()
    return [device]


def resolve_card(device: torch.device) -> torch.device:
    """`device` with its card's index: a bare "cuda" is the current card;
    any other device as it is."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
