"""The least work of each kernel's function on a request's inputs, and the
least time the card could take for it.

Counts are of what these inputs need, whatever implements them: every
input byte read once and every output byte written once, and the float32
multiplies and adds of the DCT chains, none of which may fuse (each is
rounded on its own).  A share of this least time can therefore not pass
100 % for any design that gives the same seams.

Per pass of B images (H, W) carving `seams` seams, with x_k(b, y) the
original column of seam k's pixel in row y (from the visibility map) and
p_k its column when seam k is found (x_k less the earlier seams' pixels
to its left in the row):

* energy, once a pass: every pixel's window, its n vertical chains per
  column and n * n - 1 atom chains per pixel; luma read, energy written;
* find-seam, per seam: the live energy (W - k + 1 columns) read once and
  the seam written once; 3 ops a cell of rows 1.. (two minimums, an add);
* apply, per seam: only the elements right of each row's seam move, read
  once and written once, in each plane the carve keeps (luma f32, original
  column i32, energy f32): 24 bytes each, (W - k) - p_k of them a row;
* strip, per seam: the windows that the removal changed, (max - min of
  p_k over the window's n rows) + n - 1 of them a row (clamped to the
  image), their atom chains, and the vertical chains of the band columns
  whose rows the seam crossed, (max - min) + 1 a row.
"""

from __future__ import annotations

import numpy as np
import torch

from . import peaks

__all__ = ["dct_ops", "pass_work", "least_seconds"]

APPLY_BYTES = 2 * (4 + 4 + 4)  # read and write luma, original column, energy


def dct_ops(n: int, outputs: int, columns: int) -> int:
    """The multiplies and adds of `outputs` DCT energies whose windows need
    `columns` vertical band columns: n vertical chains a column and
    n * n - 1 atom chains an output, each n multiplies and n - 1 adds."""
    return (columns * n + outputs * (n * n - 1)) * (2 * n - 1)


def _positions(vmap: torch.Tensor, seams: int) -> torch.Tensor:
    """(B, H, W) vmap -> (B, H, seams) int64: p_k, seam k's column when it
    was found."""
    big = torch.iinfo(torch.int32).max
    key = torch.where(vmap > 0, vmap, big)
    x = torch.sort(key, dim=-1, stable=True).indices[..., :seams]
    # p_k = x_k - #{j < k : x_j < x_k}
    earlier = torch.ones(seams, seams, dtype=torch.bool,
                         device=vmap.device).tril(-1)  # [k, j]: j < k
    left = (x[..., None, :] < x[..., :, None]) & earlier
    return x - left.sum(dim=-1)


def pass_work(vmap, seams: int, n: int, device="cpu",
              images_per_block: int | None = None) -> dict:
    """The least work of one pass over a (B, H, W) stack of visibility
    maps (numpy or torch): {kind: (bytes, ops)} summed over the stack."""
    vmap = torch.as_tensor(vmap)
    B, H, W = vmap.shape
    ks = np.arange(1, seams + 1, dtype=np.int64)
    live = int((W - ks + 1).sum())  # live cells a row, over the seams
    work = {
        "energy": (8 * B * H * W, B * H * dct_ops(n, W, W)),
        "find_seam": (4 * B * H * live + 4 * B * H * seams,
                      3 * B * (H - 1) * live),
        "apply": [0, 0],
        "strip": [0, 0],
    }
    if seams == 0:
        return {k: tuple(v) for k, v in work.items()}
    co = -(n // 2 - 1)
    if images_per_block is None:  # the (rows, seams, seams) pair masks
        images_per_block = max(1, (1 << 28) // max(1, H * seams * seams))
    k = torch.arange(1, seams + 1, device=device)
    for b0 in range(0, B, images_per_block):
        vm = vmap[b0:b0 + images_per_block].to(device)
        p = _positions(vm, seams)  # (b, H, seams)
        work["apply"][0] += APPLY_BYTES * int(((W - k) - p).sum())
        # the window rows of each row: y + co .. y + co + n - 1, clamped
        pad = torch.cat([p[:, :1].expand(-1, -co, -1), p,
                         p[:, -1:].expand(-1, n - 1 + co, -1)], dim=1)
        win = pad.unfold(1, n, 1)  # (b, H, seams, n)
        lo, hi = win.amin(dim=-1), win.amax(dim=-1)
        new_w = (W - k)  # the width after seam k
        first = (lo - n // 2).clamp(min=0)
        last = torch.minimum(hi + n // 2 - 2, new_w - 1)
        outputs = (last - first + 1).clamp(min=0)
        columns = (hi - lo + 1).clamp(max=new_w)
        ops = (columns * n + outputs * (n * n - 1)) * (2 * n - 1)
        work["strip"][1] += int(ops.sum())
        work["strip"][0] += 4 * int((columns * n + outputs).sum())
    return {k: tuple(v) for k, v in work.items()}


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: the bytes at the memory's peak
    rate or the unfused float32 operations at theirs, the longer."""
    return max(nbytes / peaks.HBM_BYTES_PER_S,
               ops / peaks.F32_UNFUSED_OPS_PER_S)
