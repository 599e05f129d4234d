"""Checkpoint / resume of a carve's state: the `.npz` format of the JAX
package (`dct_carver_tpu/utils/checkpoint.py`, format version 2).

The reference persists only its settings across invocations
(`gimp_set_data`, src/main.c:166-167,219-220).  Here the whole mid-carve
state (current luma + origcol + vmap + width + energy) goes into one
`.npz` with the same keys and meta as the JAX package writes, so a carve
checkpointed by either package resumes in the other.  The arrays carry over
through `utils/state.py`.

The spatial route's sharded checkpoints (`save_sharded` / `load_sharded`,
counterparts of the JAX package's) keep its commit rules with the port's
own files: each chunk writes one `.npz` per shard into a `state-%08d` step
directory, committed by renaming it into place; the step's name is the
progress counter; `meta.json` is written with a temporary file and
`os.replace`; older steps are pruned after the commit.  On a process mesh
(`parallel/shards.py::ProcessMesh`) each process writes only its own
shards, with a `process-{rank}.json` manifest listing them, and reads only
the shards its columns need; the format is the same as one controller's,
so a checkpoint resumes across the two at the same buffer width.  The JAX
package
writes these with orbax, whose directories the port cannot read: a sharded
carve resumes only in the package that wrote it (its state carries over
in memory through `utils/state.py`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import torch

from ..ops.carve import CarveState
from .config import CarverConfig
from .placement import default_device
from .state import state_from_numpy, state_to_numpy

__all__ = ["save_state", "load_state", "carve_resumable", "save_sharded",
           "load_sharded"]

_FORMAT_VERSION = 2
_SHARDED_VERSION = 1
_STEP_PREFIX = "state-"


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


def load_state(path: str, device=None):
    """Returns (CarveState on `device`, CarverConfig, seams_done,
    n_seams_total).  `device` defaults to the first CUDA card
    (`state_from_numpy`), as JAX's `load_state` puts the state on its
    default device."""
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
    carve runs (default: `luma`'s device, else the first CUDA card).  A
    resumed carve takes the checkpoint's config.
    """
    from ..ops.carve import (carve_chunks, full_energy_map, make_state,
                             strip_fits)

    if device is None:
        if isinstance(luma, torch.Tensor):
            device = luma.device
        else:
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
    counts = [min(chunk, n_seams - d) for d in range(done, n_seams, chunk)]
    # one seam step, and on a card one capture, for every chunk
    chunks = carve_chunks(state, done, counts, config.blocksize,
                          config.edges, config.textures, strip,
                          config.use_pallas, config.delta_x,
                          config.rigidity, config.tie, energy_fn)
    for count, state in zip(counts, chunks):
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


def _step_dirs(path: str) -> list[tuple[int, str]]:
    """The committed step directories under `path`, oldest first."""
    if not os.path.isdir(path):
        return []
    steps = []
    for name in os.listdir(path):
        digits = name[len(_STEP_PREFIX):]
        if name.startswith(_STEP_PREFIX) and digits.isdigit():
            steps.append((int(digits), name))
    return sorted(steps)


def save_sharded(path: str, state, mesh, meta: dict) -> None:
    """Checkpoint a sharded carve state (`parallel/spatial.py::
    SpatialCarveState` on `mesh`, a `parallel/shards.py::ShardMesh` or
    `ProcessMesh`).

    Every chunk saves into its own `state-{seams_done}` directory, written
    under a temporary name and renamed into place, so a save cut short
    never shows as a step; the progress counter is the step's name, never
    the side-car meta.json.  Older steps go only after the new one is
    committed.  `meta` must carry `seams_done`; the caller checks the carve
    parameters it holds on resume.  A committed step of the same number (a
    new run reusing the directory) is replaced.

    On a process mesh every process calls it, with a `path` that every
    process sees (a shared file system): process 0 makes the temporary
    directory; each process writes its own shards and its
    manifest; process 0 commits the step, writes meta.json and prunes, with
    a barrier after each of the three."""
    path = os.path.abspath(path)
    step = int(meta["seams_done"])
    name = f"{_STEP_PREFIX}{step:08d}"
    tmp = os.path.join(path, f".{name}.tmp")
    if mesh.rank == 0:
        os.makedirs(path, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    mesh.barrier()
    fields = ["luma", "origcol", "vmap", "energy"]
    if state.image is not None:
        fields.append("image")
    files = []
    for g, st in enumerate(mesh.stacks):
        for i in range(st.count):
            files.append(f"shard-{st.first + i:05d}.npz")
            np.savez(os.path.join(tmp, files[-1]),
                     width=np.asarray(state.width, np.int32),
                     **{f: getattr(state, f)[g][i].cpu().numpy()
                        for f in fields})
    with open(os.path.join(tmp, f"process-{mesh.rank:05d}.json"), "w") as f:
        json.dump({"process": mesh.rank, "shards": files}, f)
    mesh.barrier()
    if mesh.rank == 0:
        final = os.path.join(path, name)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        meta_full = {"version": _SHARDED_VERSION, "shards": mesh.size,
                     "buffer_width": mesh.width, **meta}
        tmp_meta = os.path.join(path, ".meta.json.tmp")
        with open(tmp_meta, "w") as f:
            json.dump(meta_full, f)
        os.replace(tmp_meta, os.path.join(path, "meta.json"))
        for s, old in _step_dirs(path):
            if s != step:
                shutil.rmtree(os.path.join(path, old), ignore_errors=True)
    mesh.barrier()


def load_sharded(path: str, devices, processes: bool = False):
    """Restore the newest committed step of a sharded checkpoint onto the
    mesh `devices` (`parallel/shards.py::shard_mesh`: with `processes`,
    this process's shards of a mesh over every process of the job; any
    global shard count that divides the saved buffer width).  Each process
    reads only the saved shards that overlap its columns.  Returns
    (SpatialCarveState, mesh, meta); meta["seams_done"] comes from the
    committed step's name."""
    from ..parallel.shards import shard_mesh
    from ..parallel.spatial import SpatialCarveState

    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta["version"] != _SHARDED_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} unsupported")
    steps = _step_dirs(path)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoint step under {path}")
    step, name = steps[-1]
    meta["seams_done"] = step
    mesh = shard_mesh(devices, meta["buffer_width"], processes)
    saved_wl = meta["buffer_width"] // meta["shards"]
    read = {}

    def saved(i):
        if i not in read:
            with np.load(os.path.join(path, name, f"shard-{i:05d}.npz")) as z:
                read[i] = {k: z[k] for k in z.files}
        return read[i]

    def parts(field):
        # each stack's (count, H, Wl[, C]) from the saved shards under it
        out = []
        for st in mesh.stacks:
            lo, hi = st.first * mesh.Wl, (st.first + st.count) * mesh.Wl
            cols = np.concatenate(
                [saved(i)[field] for i in range(lo // saved_wl,
                                                -(-hi // saved_wl))], axis=1)
            cols = cols[:, lo % saved_wl:lo % saved_wl + hi - lo]
            cols = cols.reshape(cols.shape[0], st.count, mesh.Wl,
                                *cols.shape[2:])
            out.append(torch.from_numpy(np.ascontiguousarray(
                np.moveaxis(cols, 1, 0))).to(st.device))
        return out

    head = saved(mesh.lo(0) // saved_wl)
    state = SpatialCarveState(
        luma=parts("luma"),
        image=parts("image") if "image" in head else None,
        origcol=parts("origcol"),
        vmap=parts("vmap"),
        energy=parts("energy"),
        width=int(head["width"]),
    )
    return state, mesh, meta
