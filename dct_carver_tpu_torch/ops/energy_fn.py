"""Pluggable per-pixel energy functions — the carver's analog of liblqr's
`lqr_carver_set_energy_function` (`src/render.c:314-315`).

Counterpart of `dct_carver_tpu/ops/energy_fn.py`.  An energy function is a
vectorized function over per-row vertical bands, the layout of the DCT path
(`ops/dct.py::rows_to_bands`): for output row i, ``bands[i, dy, :]`` is
image row ``clip(i + dy - (r-1))`` over contiguous columns, ``r = n // 2``.
It returns the energy of every sliding window at once, so the full map and
the per-seam strips (`ops/carve.py`) go through the same function, and a
strip update equals a full recompute.

Window correspondence with the reference's reading window
(`src/render.c:146-151`): for pixel (i, j), tap (y, x) with x, y in
-r+1 .. r is ``bands[i, y + r - 1, j + x + r - 1]``, i.e.
``lqr_rwindow_read(rw, x, y)`` == ``window[y + r - 1, x + r - 1]`` for the
(n, n) window handed to a `custom_energy` block function.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = [
    "EnergyFunction", "custom_energy", "builtin_energy", "resolve_energy",
    "GRAD_XABS", "GRAD_SUMABS", "GRAD_NORM", "ENERGY_NULL", "BUILTIN_ENERGIES",
]


class EnergyFunction(NamedTuple):
    """A pluggable energy: window size `n` (even; radius = n//2, liblqr's
    `radius`) and a vectorized `bands_fn`.

    bands_fn: (rows, n, C) float bands -> (rows, C - n + 1) energies, where
    output column p is the energy of the pixel whose window occupies band
    columns p .. p+n-1.  It must depend only on the window (locality is what
    makes strip updates exact).
    """
    name: str
    n: int
    bands_fn: Callable[[torch.Tensor], torch.Tensor]

    @property
    def radius(self) -> int:
        return self.n // 2

    def energy_map(self, luma: torch.Tensor,
                   center: str = "carve") -> torch.Tensor:
        """Full-image energy of a (H, W) plane or (B, H, W) stack
        (edge-clamped windows), in the dtype `bands_fn` returns."""
        from .dct import rows_to_bands

        bands = rows_to_bands(luma, self.n, center)  # (..., H, n, W+n-1)
        out = self.bands_fn(bands.reshape(-1, *bands.shape[-2:]))
        return out.reshape(luma.shape)


def _validated(fn: EnergyFunction) -> EnergyFunction:
    if fn.n < 2 or fn.n % 2:
        raise ValueError(f"energy window size must be even and >= 2, got {fn.n}")
    return fn


def custom_energy(radius: int,
                  block_fn: Callable[[torch.Tensor], torch.Tensor],
                  name: str = "custom") -> EnergyFunction:
    """Energy from a per-window function — the closest analog of the
    reference's per-pixel callback + reading window (src/render.c:134-157).

    block_fn: (n, n) window -> scalar energy, n = 2 * radius; window[dy, dx]
    is the edge-clamped pixel at offset (dy - (r-1), dx - (r-1)) from the
    center.  It is mapped over all windows with `torch.func.vmap`, so write
    it in plain torch ops.  This wrapper materializes the (rows, Cout, n, n)
    window stack; a hand-vectorized EnergyFunction (see GRAD_* below) avoids
    that.
    """
    if radius < 1:
        raise ValueError(f"radius must be >= 1, got {radius}")
    n = 2 * radius

    def bands_fn(bands: torch.Tensor) -> torch.Tensor:
        if bands.shape[1] != n:
            raise ValueError(f"bands hold {bands.shape[1]} rows, expected {n}")
        # unfold: (rows, n, Cout, n) [b, dy, p, dx] — window p spans band
        # columns p..p+n-1; then (rows, Cout, n, n) [b, p, dy, dx]
        wins = bands.unfold(-1, n, 1).movedim(2, 1)
        return torch.func.vmap(torch.func.vmap(block_fn))(wins)

    return _validated(EnergyFunction(name, n, bands_fn))


# --------------------------------------------------------------- builtins --
# liblqr-style builtin gradient energies (the library's non-custom options).
# All use a 2x2 window (radius 1): with carve centering the taps sit at
# offsets {0, +1} in both dims, so dx/dy are forward differences with the
# edge-clamped border giving 0 at the last column/row.  Each is elementwise
# (every op rounded on its own), so its values do not depend on the shape
# it is given: strip == full bit for bit.

def _forward_diffs(bands: torch.Tensor):
    x = bands[:, 0, :-1]
    dx = bands[:, 0, 1:] - x   # right neighbor - pixel
    dy = bands[:, 1, :-1] - x  # down neighbor - pixel
    return dx, dy


def _grad_xabs(bands):
    dx, _ = _forward_diffs(bands)
    return torch.abs(dx)


def _grad_sumabs(bands):
    dx, dy = _forward_diffs(bands)
    return (torch.abs(dx) + torch.abs(dy)) * 0.5


def _grad_norm(bands):
    dx, dy = _forward_diffs(bands)
    s = dx * dx + dy * dy
    # PyTorch's vectorized CPU sqrt is not correctly rounded (off by an ulp
    # in ~0.6 % of f32 inputs); the square root taken in f64 and rounded
    # back is, on every device, so the map equals NumPy's and JAX's
    return torch.sqrt(s.to(torch.float64)).to(s.dtype)


def _null(bands):
    return torch.zeros_like(bands[:, 0, :-1])


GRAD_XABS = EnergyFunction("grad_xabs", 2, _grad_xabs)
GRAD_SUMABS = EnergyFunction("grad_sumabs", 2, _grad_sumabs)
GRAD_NORM = EnergyFunction("grad_norm", 2, _grad_norm)
ENERGY_NULL = EnergyFunction("null", 2, _null)

BUILTIN_ENERGIES = {
    fn.name: fn for fn in (GRAD_XABS, GRAD_SUMABS, GRAD_NORM, ENERGY_NULL)
}


def builtin_energy(name: str) -> EnergyFunction:
    try:
        return BUILTIN_ENERGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown builtin energy {name!r}; options: "
            f"{sorted(BUILTIN_ENERGIES)} (or 'dct' via energy_fn=None)"
        ) from None


def resolve_energy(energy) -> EnergyFunction | None:
    """None / 'dct' -> None (the default DCT path); a builtin name or an
    EnergyFunction passes through."""
    if energy is None or energy == "dct":
        return None
    if isinstance(energy, EnergyFunction):
        return _validated(energy)
    if isinstance(energy, str):
        return builtin_energy(energy)
    raise TypeError(f"energy must be None, a name, or an EnergyFunction; "
                    f"got {type(energy).__name__}")
