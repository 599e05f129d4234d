"""Checkpoint / resume of a carve's state: the `.npz` format of the JAX
package (`dct_carver_tpu/utils/checkpoint.py`, format version 2).

The reference persists only its settings across invocations
(`gimp_set_data`, src/main.c:166-167,219-220).  Here the whole mid-carve
state (current luma + origcol + vmap + width + energy) goes into one
`.npz` with the same keys and meta as the JAX package writes, so a carve
checkpointed by either package resumes in the other.  The arrays carry over
through `utils/state.py`.  The sharded (orbax) format of the JAX package
comes with the spatial route (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..ops.carve import CarveState
from .config import CarverConfig
from .state import state_from_numpy, state_to_numpy

__all__ = ["save_state", "load_state", "carve_resumable"]

_FORMAT_VERSION = 2


def _config_to_jsonable(config: CarverConfig) -> dict:
    from ..ops.energy_fn import BUILTIN_ENERGIES, EnergyFunction

    d = dataclasses.asdict(config)
    e = config.energy
    if isinstance(e, EnergyFunction):
        if BUILTIN_ENERGIES.get(e.name) is not e:
            raise ValueError(
                "custom EnergyFunction objects cannot be checkpointed; "
                "pass the builtin name in config.energy, or re-supply the "
                "function on resume"
            )
        d["energy"] = e.name
    return d


def save_state(path: str, state: CarveState, config: CarverConfig,
               seams_done: int, n_seams_total: int) -> None:
    """Write a single-image `state` to `path` (copies it to the host)."""
    meta = {
        "version": _FORMAT_VERSION,
        "seams_done": int(seams_done),
        "n_seams_total": int(n_seams_total),
        "config": _config_to_jsonable(config),
    }
    np.savez_compressed(
        path, **state_to_numpy(state),
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    )


def load_state(path: str, device="cpu"):
    """Returns (CarveState on `device`, CarverConfig, seams_done,
    n_seams_total)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["version"] not in (1, _FORMAT_VERSION):
            raise ValueError(
                f"checkpoint version {meta['version']} unsupported")
        state = state_from_numpy(z, device=device)
    cfg = CarverConfig(**meta["config"])
    return state, cfg, meta["seams_done"], meta["n_seams_total"]


def carve_resumable(luma, n_seams: int, config: CarverConfig, *,
                    checkpoint_path: str | None = None,
                    checkpoint_every: int = 0,
                    resume_from: str | None = None, progress=None,
                    device=None) -> CarveState:
    """Carve with optional periodic checkpointing and resume.

    Runs the seam loop in chunks of `checkpoint_every` seams (0 = one
    chunk) and waits for the device once a chunk, then reports progress and
    writes the checkpoint.  `progress` is an optional `Progress`
    (utils/progress.py) mirroring the liblqr progress hooks.  `luma`: the
    (H, W) plane to carve (unused when resuming); `device`: where a resumed
    carve runs (default: `luma`'s device, else `default_device()`).  A
    resumed carve takes the checkpoint's config.
    """
    from ..ops.carve import (carve_seams, full_energy_map, make_state,
                             strip_fits)

    if device is None:
        if isinstance(luma, torch.Tensor):
            device = luma.device
        else:
            from ..models.carver import default_device

            device = default_device()
    if resume_from is not None:
        state, config, done, total = load_state(resume_from, device)
        if total != n_seams:
            raise ValueError(
                f"checkpoint was for {total} seams, requested {n_seams}")
    energy_fn = config.energy_function
    if resume_from is None:
        luma = torch.as_tensor(luma, device=device)
        state = make_state(luma.clone())
        state = state._replace(energy=full_energy_map(
            state.luma, config.blocksize, config.edges, config.textures,
            use_pallas=config.use_pallas, energy_fn=energy_fn))
        done = 0

    chunk = checkpoint_every if checkpoint_every > 0 else n_seams
    # the tiny-image guard of carve_n_seams: strips must fit in the buffer
    strip = config.strip_update and strip_fits(
        state.luma.shape[-1], config.blocksize, config.delta_x, energy_fn)

    if progress is not None:
        from .i18n import _ as _t

        progress.init(_t("Resizing width..."))
    while done < n_seams:
        count = min(chunk, n_seams - done)
        state = carve_seams(state, done, count, config.blocksize,
                            config.edges, config.textures, strip,
                            config.use_pallas, config.delta_x,
                            config.rigidity, config.tie, energy_fn)
        if state.luma.is_cuda:
            torch.cuda.synchronize(state.luma.device)
        done += count
        if progress is not None:
            progress.update(done / n_seams)
        if checkpoint_path is not None:
            save_state(checkpoint_path, state, config, done, n_seams)
    if progress is not None:
        progress.end()
    return state
