"""Blockwise sliding-window DCT energy — the plain PyTorch version.

Counterpart of `dct_carver_tpu/ops/dct.py`, and the plain version of the
energy kernel (`csrc/energy.cu`, wrapped by `kernels/energy_kernel.py`).

Both DCT stages are explicit chains of separate multiplies and adds on
whole tensors, never `matmul`, `einsum`, `addcmul` or `torch.compile`:
each elementwise op is one exactly rounded IEEE op, so the result is fixed
by the op order alone, on any device.  The CUDA kernels replay the same
order with `__fmul_rn`/`__fadd_rn`, and the two agree bit for bit.

DCT conventions (oracle/reference.py of the JAX package):
  * N in {8,16}: orthonormal DCT-II (src/fft2d/shrtdct.c:190-205).
  * N in {2,4}:  unnormalized case-2 ddct2d (src/fft2d/fftsg2d.c:200-211).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["dct_energy_map", "energy_from_bands", "rows_to_bands",
           "window_offset", "BLOCKSIZES", "ky_picks", "combine_picks",
           "pick_energy"]

BLOCKSIZES = (2, 4, 8, 16)


@functools.lru_cache(maxsize=None)
def _dct_matrix_np(n: int) -> np.ndarray:
    if n not in BLOCKSIZES:
        raise ValueError(f"blocksize must be one of {BLOCKSIZES}, got {n}")
    j = np.arange(n, dtype=np.float64)
    k = np.arange(n, dtype=np.float64)
    D = np.cos(np.pi * (j[None, :] + 0.5) * k[:, None] / n)
    if n in (8, 16):
        s = np.full(n, math.sqrt(2.0 / n))
        s[0] = math.sqrt(1.0 / n)
        D = D * s[:, None]
    return D


def _taps(n: int, dtype: torch.dtype) -> list[list[float]]:
    """The taps rounded to `dtype`, as Python floats (exactly representable
    in `dtype`, so the scalar multiply rounds nothing further)."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return _dct_matrix_np(n).astype(np_dtype).tolist()


def energy_from_bands(bands: torch.Tensor, n: int, edges,
                      textures) -> torch.Tensor:
    """Energy for every sliding window of a per-row vertical band.

    bands: (..., H, n, C) — for output row i, bands[..., i, dy, :] is the
    image row i + dy + co (edge-clamped) over C contiguous columns.  Output
    (..., H, C - n + 1): energy of the window whose LEFT tap starts at each
    column.

    Semantics (src/dct.c:96-110): max |coefficient| over non-DC atoms with
    last-tie-wins in rank = kx*n + ky, weighted by `edges` for atoms
    (0,1)/(1,0) else `textures`.
    """
    *lead, nb, C = bands.shape
    if nb != n:
        raise ValueError(f"bands hold {nb} rows, expected {n}")
    Cout = C - n + 1
    D = _taps(n, bands.dtype)

    # stage 1 — vertical 1-D DCT: V[ky][i, c] = sum_dy D[ky, dy] * bands[i, dy, c]
    V = []
    for ky in range(n):
        v = D[ky][0] * bands[..., 0, :]
        for dy in range(1, n):
            v = v + D[ky][dy] * bands[..., dy, :]
        V.append(v)

    # stage 2 — horizontal sliding DCT + running argmax: DC excluded,
    # last tie wins in rank = kx*n + ky
    maxval = torch.full((*lead, Cout), -math.inf, dtype=bands.dtype,
                        device=bands.device)
    winner = torch.full((*lead, Cout), -1, dtype=torch.int32,
                        device=bands.device)
    for ky in range(n):
        sh = [V[ky][..., dx : dx + Cout] for dx in range(n)]
        kx0 = 1 if ky == 0 else 0  # DC atom (0,0) excluded (src/dct.c:103)
        for kx in range(kx0, n):
            t = D[kx][0] * sh[0]
            for dx in range(1, n):
                t = t + D[kx][dx] * sh[dx]
            a = torch.abs(t)
            rank = kx * n + ky
            take_new = a > maxval
            tie = a == maxval
            winner = torch.where(
                take_new, rank,
                torch.where(tie, winner.clamp(min=rank), winner),
            )
            maxval = torch.maximum(maxval, a)

    is_edge = (winner == 1) | (winner == n)  # atoms (0,1),(1,0) (src/dct.c:10-43)
    w = torch.where(
        is_edge,
        torch.tensor(edges, dtype=bands.dtype, device=bands.device),
        torch.tensor(textures, dtype=bands.dtype, device=bands.device),
    )
    return maxval * w


def ky_picks(bands: torch.Tensor, n: int):
    """The kernels' decomposition of `energy_from_bands`'s running argmax
    (`csrc/energy_chain.cuh`): for each ky, the pick of that ky's row of
    atoms, a (value, rank) pair of (..., H, C - n + 1) tensors holding the
    largest |coefficient| over kx (DC excluded) and, among equal values,
    the largest rank kx*n + ky; (-inf, -1) where there is none.  Same
    chains, same op order as `energy_from_bands`."""
    *lead, nb, C = bands.shape
    if nb != n:
        raise ValueError(f"bands hold {nb} rows, expected {n}")
    Cout = C - n + 1
    D = _taps(n, bands.dtype)
    picks = []
    for ky in range(n):
        v = D[ky][0] * bands[..., 0, :]
        for dy in range(1, n):
            v = v + D[ky][dy] * bands[..., dy, :]
        sh = [v[..., dx:dx + Cout] for dx in range(n)]
        m = torch.full((*lead, Cout), -math.inf, dtype=bands.dtype,
                       device=bands.device)
        rank = torch.full((*lead, Cout), -1, dtype=torch.int32,
                          device=bands.device)
        for kx in range(1 if ky == 0 else 0, n):
            t = D[kx][0] * sh[0]
            for dx in range(1, n):
                t = t + D[kx][dx] * sh[dx]
            a = torch.abs(t)
            take = a >= m  # ranks grow with kx: a later equal value wins
            m = torch.where(take, a, m)
            rank = torch.where(take, kx * n + ky, rank)
        picks.append((m, rank))
    return picks


def combine_picks(p, q):
    """The pick of two picks (value, rank): q's where its value is larger,
    or equal with a larger rank.  A lexicographic maximum, so picks combine
    in any order (the kernels combine per-ky picks across threads)."""
    (pv, pr), (qv, qr) = p, q
    take = (qv > pv) | ((qv == pv) & (qr > pr))
    return torch.where(take, qv, pv), torch.where(take, qr, pr)


def pick_energy(pick, n: int, edges, textures) -> torch.Tensor:
    """The energy of a combined pick: its value weighted by `edges` for
    atoms (0,1)/(1,0), else `textures` (as `energy_from_bands`)."""
    v, rank = pick
    is_edge = (rank == 1) | (rank == n)
    w = torch.where(is_edge,
                    torch.tensor(edges, dtype=v.dtype, device=v.device),
                    torch.tensor(textures, dtype=v.dtype, device=v.device))
    return v * w


def window_offset(n: int, center: str = "carve") -> int:
    """First window offset relative to the pixel: "carve" = liblqr reading
    window (src/render.c:146-151); "preview" = the GUI preview centering
    (CENTER_ROW/COL, src/dct.h:8-9)."""
    if center == "carve":
        return -(n // 2 - 1)
    if center == "preview":
        return -((n - 1) // 2 - 1)
    raise ValueError(f"center must be 'carve' or 'preview', got {center!r}")


def rows_to_bands(luma: torch.Tensor, n: int,
                  center: str = "carve") -> torch.Tensor:
    """(..., H, W) -> (..., H, n, W + n - 1): per-output-row vertical band
    with edge-clamped rows and columns (window offsets co..co+n-1)."""
    H, W = luma.shape[-2:]
    co = window_offset(n, center)
    dev = luma.device
    col_idx = (torch.arange(W + n - 1, device=dev) + co).clamp(0, W - 1)
    padded = luma[..., col_idx]  # (..., H, W+n-1)
    row_idx = (torch.arange(H, device=dev)[:, None] + co
               + torch.arange(n, device=dev)[None, :]).clamp(0, H - 1)
    return padded[..., row_idx, :]  # (..., H, n, W+n-1)


def dct_energy_map(luma: torch.Tensor, blocksize: int, edges, textures, *,
                   center: str = "carve") -> torch.Tensor:
    """Per-pixel DCT energy of a (..., H, W) luma plane or stack, in
    `luma.dtype`."""
    n = blocksize
    return energy_from_bands(rows_to_bands(luma, n, center), n, edges,
                             textures)
