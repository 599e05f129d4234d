"""The per-row strip around a removed seam, and the plain versions of the
strip kernels (`kernels/strip_kernel.py`) and of the apply's edge fill
(`kernels/apply_kernel.py`): the strip helpers of
`dct_carver_tpu/ops/carve.py`.  A pixel's energy changes only if its window
overlaps a changed column, so row i recomputes the `strip_w` columns from
clip(seam_i - half, 0, W - strip_w) through the same energy chain as a full
recompute: strip == full bit for bit (docs/PARITY.md S5).  The spatial
route runs it on a stack of column shards of one image (`ShardOffset`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .dct import energy_from_bands, window_offset

__all__ = ["ShardOffset", "energy_window", "strip_fits"]


class ShardOffset(NamedTuple):
    """Where a (S, H, Wl) stack of column shards lies in one image (the
    spatial route, `parallel/spatial.py`): shard s owns global columns
    [lo + s*Wl, lo + (s+1)*Wl) of a buffer `width` columns wide, and its
    luma plane carries the edge-clamped halo of an n-wide window, r-1
    columns before its own and r after (r = n // 2), so it is Wl + n - 1
    wide.  Strip starts are clamped to `width`, as on one device."""
    lo: int
    width: int


def _shard_origins(shard: ShardOffset, S: int, Wl: int, device):
    """(S,) int64: the global column of each shard's first owned column."""
    return shard.lo + Wl * torch.arange(S, device=device)


def _edge_fill(luma: torch.Tensor, width) -> torch.Tensor:
    """Replicate column width-1 into the dead region (border clamp).
    `width`: an int, or a tensor of one width an image ((B,) for a (B, H,
    W) stack, (1,) for a plane)."""
    col = torch.arange(luma.shape[-1], device=luma.device)
    if not isinstance(width, torch.Tensor):
        return torch.where(col < width, luma, luma[..., width - 1 : width])
    w = width.to(torch.int64).reshape(*luma.shape[:-2], 1, 1)
    edge = luma.gather(-1, (w - 1).expand(*luma.shape[:-1], 1))
    return torch.where(col < w, luma, edge)


def energy_window(blocksize: int, energy_fn=None) -> int:
    """The energy's window size: the plugged energy's `n` when there is
    one, else `blocksize`."""
    return energy_fn.n if energy_fn is not None else blocksize


def _strip_extent(blocksize: int, delta_x: int = 1) -> tuple[int, int]:
    """(half, strip_w) of the per-row strip around a removed seam.

    After removing column s_i in row i, pixel (i, j) has a changed window
    iff some row r within the window's vertical extent has |j - s_r| <=
    r_blk (+1 for the index shift), and |s_r - s_i| <= delta_x *
    blocksize/2 within the extent, so half = blocksize/2 * (1 + delta_x) + 1
    suffices; strip_w = 2 * half + 2 leaves a little slack.
    """
    half = (blocksize // 2) * (1 + delta_x) + 1
    return half, 2 * half + 2


def strip_fits(W: int, blocksize: int, delta_x: int = 1,
               energy_fn=None) -> bool:
    """Whether the per-row strip fits a buffer `W` wide; narrower buffers
    recompute the full map every seam."""
    return W >= _strip_extent(energy_window(blocksize, energy_fn),
                              delta_x)[1]


def _strip_bounds(seam: torch.Tensor, blocksize: int, W: int,
                  delta_x: int = 1):
    """(start (..., H) int64, strip_w): row i's strip is columns
    [start_i, start_i + strip_w)."""
    half, strip_w = _strip_extent(blocksize, delta_x)
    start = (seam.to(torch.int64) - half).clamp(0, max(W - strip_w, 0))
    return start, strip_w


def _gather_strip_bands(luma: torch.Tensor, seam: torch.Tensor, n: int,
                        delta_x: int = 1,
                        shard: ShardOffset | None = None) -> torch.Tensor:
    """The plain version of the strip gather kernel: each row's band of the
    compacted, edge-filled `luma` around the removed `seam`.  luma:
    (..., H, W); seam: (..., H).  Returns (..., H, n, strip_w + n - 1):
    bands[..., i, dy, t] = luma[..., clip(i + co + dy), clip(start_i + co
    + t)] with co = window_offset(n, "carve").  With `shard`, luma is a
    (S, H, Wl + n - 1) stack of shards with their halos, seam the (H,) seam
    they share, and each band column is read at its global column (clamped
    to the shard's plane)."""
    H, Wx = luma.shape[-2:]
    dev = luma.device
    co = window_offset(n, "carve")
    W = Wx if shard is None else shard.width
    start, strip_w = _strip_bounds(seam, n, W, delta_x)
    cols = start[..., None] + co + torch.arange(strip_w + n - 1, device=dev)
    if shard is not None:
        # luma column 0 of shard s is global column origin_s - (r - 1)
        x0 = _shard_origins(shard, luma.shape[0], Wx - n + 1, dev) + co
        cols = cols[None] - x0[:, None, None]
    cols = cols.clamp(0, Wx - 1)
    rows = (torch.arange(H, device=dev)[:, None] + co
            + torch.arange(n, device=dev)[None, :]).clamp(0, H - 1)
    # (B, H, n, strip_w+n-1): row i's band reads rows[i] at cols[..., i, :]
    planes = luma.reshape(-1, H, Wx)
    b = torch.arange(planes.shape[0], device=dev)[:, None, None, None]
    bands = planes[b, rows[:, :, None],
                   cols.reshape(-1, H, strip_w + n - 1)[:, :, None, :]]
    return bands.reshape(*luma.shape[:-2], H, n, strip_w + n - 1)


def _scatter_strips(energy: torch.Tensor, strip: torch.Tensor,
                    seam: torch.Tensor, n: int, delta_x: int = 1,
                    shard: ShardOffset | None = None) -> torch.Tensor:
    """The plain version of the strip scatter kernel: write, in place, each
    row's (..., H, strip_w) strip into the compacted `energy` at the row's
    strip start, and return `energy`.  With `shard`, energy is a (S, H, Wl)
    stack of shards and each keeps the strip columns it owns."""
    W = energy.shape[-1]
    dev = energy.device
    start, strip_w = _strip_bounds(seam, n, W if shard is None
                                   else shard.width, delta_x)
    idx = start[..., None] + torch.arange(strip_w, device=dev)
    if shard is None:
        return energy.scatter_(-1, idx, strip.to(energy.dtype))
    idx = idx[None] - _shard_origins(shard, energy.shape[0], W,
                                     dev)[:, None, None]
    # columns of other shards land in one extra column, which is dropped
    idx = torch.where((idx >= 0) & (idx < W), idx, W)
    spill = torch.zeros_like(energy[..., :1])
    padded = torch.cat([energy, spill], dim=-1)
    padded.scatter_(-1, idx, strip.to(energy.dtype))
    return energy.copy_(padded[..., :W])


def _recompute_strip(luma: torch.Tensor, energy: torch.Tensor,
                     seam: torch.Tensor, blocksize: int, edges, textures,
                     delta_x: int = 1,
                     shard: ShardOffset | None = None) -> torch.Tensor:
    """The plain version of the DCT strip kernel: overwrite, in place, each
    row's strip of the compacted `energy` with the energy of the compacted,
    edge-filled `luma`.  Returns `energy`.  luma, energy: (..., H, W);
    seam: (..., H); with `shard`, a stack of shards (`ShardOffset`)."""
    bands = _gather_strip_bands(luma, seam, blocksize, delta_x, shard)
    strip = energy_from_bands(bands, blocksize, edges, textures)
    return _scatter_strips(energy, strip, seam, blocksize, delta_x, shard)
