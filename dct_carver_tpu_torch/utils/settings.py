"""Persistent last-used settings — the plugin's run-mode data store.

The reference persists its `PlugInVals` between invocations with
`gimp_set_data`/`gimp_get_data` (`src/main.c:166-167,219-220`)
and offers a GIMP_RUN_WITH_LAST_VALS run mode that reuses them
(`src/main.c:193-205`).  Here the same nine knobs live in a small JSON file;
the CLI saves them after every successful carve and `--last-vals` reruns
with the stored values.

A copy of `dct_carver_tpu/utils/settings.py`: the same knobs in the same
file, so both packages' CLIs share one store of last-used settings.  Like
the JAX package, it does not store `energy` or `tie` (ROADMAP Queue 3).
"""

from __future__ import annotations

import json
import os

__all__ = ["save_last_vals", "load_last_vals", "settings_path"]

_KNOBS = (
    "seams_number", "blocksize", "edges", "textures", "vertically",
    "output_energy", "output_seams", "luma", "delta_x", "rigidity",
)


def settings_path() -> str:
    base = os.environ.get(
        "DCT_CARVER_STATE_DIR",
        os.path.join(
            os.environ.get(
                "XDG_CONFIG_HOME", os.path.expanduser("~/.config")
            ),
            "dct_carver_tpu",
        ),
    )
    return os.path.join(base, "last_vals.json")


def save_last_vals(vals: dict) -> None:
    path = settings_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    stored = {k: vals[k] for k in _KNOBS if k in vals}
    with open(path, "w") as f:
        json.dump(stored, f, indent=1)


def load_last_vals() -> dict:
    """Stored knobs, or {} when none were saved yet."""
    try:
        with open(settings_path()) as f:
            vals = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}
    return {k: v for k, v in vals.items() if k in _KNOBS}
