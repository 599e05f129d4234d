"""Seam dynamic programming + seam removal (plain PyTorch).

Counterpart of `dct_carver_tpu/ops/dp.py`, and the plain version of the
find-seam kernel (`csrc/find_seam.cu`, wrapped by `kernels/dp_kernel.py`).
It is also the only DP for `delta_x != 1` or `rigidity != 0`, which the
kernel does not implement.

* Cumulative energy ``M[i,j] = E[i,j] + min(M[i-1,j-1], M[i-1,j], M[i-1,j+1])``
  (delta_x=1, rigidity=0 per `src/render.c:313`), one row at a time.
* Backtracking row by row with a (2*delta_x+1)-wide window; the column stays
  a device tensor, so the loop never waits for the device.
* Seam removal as a branch-free roll + select over a fixed-width buffer.

Every function takes a (H, W) plane or a (B, H, W) stack: each op of a row
runs on all B images at once, in the same order as on one plane, so a stack
gives each image the seam it gives alone.  `mask_energy` takes a window per
image, as `find_seams_vec(E, width, lo)` does.

Tie conventions: `tie` picks the leftmost (default) or rightmost minimum at
the last row AND among the backtrack candidates (docs/PARITY.md S1/S2).
"""

from __future__ import annotations

import math

import torch

__all__ = ["cumulative_energy", "backtrack", "find_seam", "remove_seam",
           "mask_energy", "check_tie", "TIES", "parent_directions",
           "backtrack_windowed", "backtrack_blocked", "find_seam_tiled"]

TIES = ("leftmost", "rightmost")


def check_tie(tie: str) -> str:
    if tie not in TIES:
        raise ValueError(f"tie must be one of {TIES}, got {tie!r}")
    return tie


def _argmin_tie(x: torch.Tensor, tie: str) -> torch.Tensor:
    """Index (int64, x's shape without its last dimension) of the
    `tie`-most minimum along the last dimension."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    hit = x == x.amin(dim=-1, keepdim=True)
    if tie == "leftmost":
        return torch.where(hit, idx, n).amin(dim=-1)
    return torch.where(hit, idx, -1).amax(dim=-1)


def _rigidity_penalties(delta_x: int, rigidity: float) -> list[float]:
    """A step of |dx| costs ``rigidity * |dx| / delta_x`` (the JAX package's
    spec of liblqr's `lqr_carver_init(delta_x, rigidity)`)."""
    return [rigidity * abs(dx) / delta_x for dx in range(-delta_x, delta_x + 1)]


def _shift_row(row: torch.Tensor, dx: int) -> torch.Tensor:
    """row (..., W) shifted so index j holds row[..., j + dx]; vacated slots
    are +inf."""
    if dx == 0:
        return row
    fill = torch.full((*row.shape[:-1], abs(dx)), math.inf, dtype=row.dtype,
                      device=row.device)
    if dx < 0:
        return torch.cat([fill, row[..., :dx]], dim=-1)
    return torch.cat([row[..., dx:], fill], dim=-1)


def cumulative_energy(E: torch.Tensor, delta_x: int = 1,
                      rigidity: float = 0.0) -> torch.Tensor:
    """(..., H, W) energy -> (..., H, W) DP cumulative energy, op order
    E + min(min(left, centre), right) at the default (1, 0)."""
    pen = _rigidity_penalties(delta_x, rigidity)
    M = torch.empty_like(E)
    M[..., 0, :] = E[..., 0, :]
    prev = E[..., 0, :]
    for i in range(1, E.shape[-2]):
        best = None
        for k, dx in enumerate(range(-delta_x, delta_x + 1)):
            cand = _shift_row(prev, dx)
            if pen[k] != 0.0:
                cand = cand + pen[k]
            best = cand if best is None else torch.minimum(best, cand)
        prev = E[..., i, :] + best
        M[..., i, :] = prev
    return M


def backtrack(M: torch.Tensor, delta_x: int = 1, rigidity: float = 0.0,
              tie: str = "leftmost") -> torch.Tensor:
    """(..., H, W) cumulative energy -> (..., H) int32 seam columns."""
    check_tie(tie)
    H = M.shape[-2]
    k = 2 * delta_x + 1
    Mp = torch.nn.functional.pad(M, (delta_x, delta_x), value=math.inf)
    pen = torch.tensor(_rigidity_penalties(delta_x, rigidity), dtype=M.dtype,
                       device=M.device)
    offs = torch.arange(k, device=M.device)
    j = _argmin_tie(M[..., -1, :], tie)
    seam = [j]
    for i in range(H - 2, -1, -1):
        # padded window [j-delta_x .. j+delta_x]; borders +inf, never chosen
        win = Mp[..., i, :].gather(-1, j[..., None] + offs)
        if rigidity != 0.0:
            win = win + pen
        j = j - delta_x + _argmin_tie(win, tie)
        seam.append(j)
    return torch.stack(seam[::-1], dim=-1).to(torch.int32)


def parent_directions(M: torch.Tensor, tie: str = "leftmost") -> torch.Tensor:
    """(..., H, W) cumulative energy -> (..., H, W) int8: for each cell of
    rows 1.., the step -1/0/+1 to the `tie`-most minimum of (left, centre,
    right) in the row above, +inf beyond the borders; row 0 holds 0.  The
    parents the find-seam kernel (`csrc/find_seam.cu`) writes."""
    check_tie(tie)
    prev = M[..., :-1, :]
    left, right = _shift_row(prev, -1), _shift_row(prev, 1)
    if tie == "leftmost":
        p = torch.where(left <= prev, torch.where(left <= right, -1, 1),
                        torch.where(prev <= right, 0, 1))
    else:
        p = torch.where(right <= prev, torch.where(right <= left, 1, -1),
                        torch.where(prev <= left, 0, -1))
    return torch.cat([torch.zeros_like(M[..., :1, :], dtype=p.dtype), p],
                     dim=-2).to(torch.int8)


def backtrack_windowed(P: torch.Tensor, last: torch.Tensor, K: int = 64,
                       tie: str = "leftmost") -> torch.Tensor:
    """The find-seam kernel's backtrack: the `tie`-most argmin of the last
    DP row `last` (..., W), then a walk up the parents P (..., H, W) of
    `parent_directions` in windows of K rows.  A seam moves at most one
    column a row, so below column j the next K rows stay inside
    [j - K, j + K]; each window (clamped to [0, W)) is copied whole before
    it is walked.  -> (..., H) int32.  It gives `backtrack`'s seams, and
    is here to hold the kernel's algorithm to them."""
    check_tie(tie)
    H, W = P.shape[-2:]
    ww = min(2 * K + 1, W)
    offs = torch.arange(ww, device=P.device)
    j = _argmin_tie(last, tie)
    seam = [j] * H
    for top in range(H - 1, 0, -K):
        rows = min(K, top)
        ws = (j - K).clamp(0, W - ww)
        idx = (ws[..., None] + offs)[..., None, :].expand(
            *P.shape[:-2], rows, ww)
        # window row r is parent row top - r
        win = P[..., top - rows + 1:top + 1, :].flip(-2).gather(-1, idx)
        jl = j - ws
        for r in range(rows):
            step = win[..., r, :].gather(-1, jl[..., None])[..., 0]
            jl = (jl + step).clamp(0, ww - 1)
            seam[top - r - 1] = jl + ws
        j = jl + ws
    return torch.stack(seam, dim=-1).to(torch.int32)


def backtrack_blocked(P: torch.Tensor, last: torch.Tensor, R: int = 64,
                      tie: str = "leftmost") -> torch.Tensor:
    """The tiled find-seam kernel's finish (`csrc/find_seam_tiled.cu`
    `finish_kernel`): the `tie`-most argmin of the last DP row `last`
    (..., W), then the walk up the parents P (..., H, W) of
    `parent_directions` in blocks of R rows.  Block k holds parent rows
    kR + 1 .. min((k + 1)R, H - 1).  A step is c = clamp(c + P[r, c], 0,
    W - 1), so the R steps of a block compose into one map a column, the
    jump from its bottom row to its top row (at most R columns).

    Compose: every block's jump for every column.  Walk the blocks: the
    seam's column at each block's bottom row, from the last row up, one
    jump a block.  Fill: each block's rows from its bottom column.  ->
    (..., H) int32.  It gives `backtrack_windowed`'s seams, and is here to
    hold the kernel's algorithm to them."""
    check_tie(tie)
    if R < 1:
        raise ValueError(f"R must be >= 1, got {R}")
    H, W = P.shape[-2:]
    P = P.to(torch.int64)
    blocks = [(k * R + 1, min((k + 1) * R, H - 1))
              for k in range(-(-(H - 1) // R))]

    def walk(c, top, bot, seam=None):
        # parent rows bot .. top from the columns c at row bot
        for r in range(bot, top - 1, -1):
            c = (c + P[..., r, :].gather(-1, c)).clamp(0, W - 1)
            if seam is not None:
                seam[r - 1] = c[..., 0]
        return c

    cols = torch.arange(W, device=P.device).expand(P.shape[:-2] + (W,))
    jumps = [walk(cols, top, bot) - cols for top, bot in blocks]
    seam = [_argmin_tie(last, tie)] * H  # rows 0 .. H - 2 filled below
    j, bottom = seam[-1], [None] * len(blocks)
    for k in reversed(range(len(blocks))):
        bottom[k] = j
        j = j + jumps[k].gather(-1, j[..., None])[..., 0]
    for (top, bot), c in zip(blocks, bottom):
        walk(c[..., None], top, bot, seam)
    return torch.stack(seam, dim=-1).to(torch.int32)


def find_seam_tiled(E: torch.Tensor, width, lo=0, tie: str = "leftmost", *,
                    tile: int = 64, K: int = 32, group: int = 1,
                    R: int = 64) -> torch.Tensor:
    """The tiled find-seam kernel's algorithm (`csrc/find_seam_tiled.cu`):
    (..., H, W) energy, masked to the column window [lo, lo + width) (ints,
    or (B,) tensors for a stack), -> (..., H) int32 seams.

    The row is cut into tiles of `tile` owned columns, each computed over
    an extended row with Hh = K rounded up to 4 halo columns a side (+inf
    outside [0, W)), K rows at a time from a frontier that holds the last
    DP row of the K rows before (one slice a block in the kernel).  Each
    tile keeps
    the parents and the last row of its owned columns only; the owned
    values are exact because a value |dc| columns from the extended row's
    ends is exact for |dc| rows.  The kernel's warps each take `group`
    adjacent tiles, block by block; the tiles' order within a block does
    not change a value, so here `group` only nests the loop.  Then
    `backtrack_blocked` in blocks of R rows.  It gives `find_seam`'s
    seams, and is here to hold the kernel's algorithm to them.  The
    defaults are the kernel's (`kernels/dp_kernel.py`'s TILE_W, TILE_K and
    FINISH_ROWS)."""
    check_tie(tie)
    if tile < 4 or tile % 4 or K < 1 or group < 1:
        raise ValueError(f"tile must be a positive multiple of 4, K >= 1 "
                         f"and group >= 1, got tile={tile}, K={K}, "
                         f"group={group}")
    H, W = E.shape[-2:]
    Hh = (K + 3) // 4 * 4
    masked = mask_energy(E, width, lo)
    inf = torch.tensor(math.inf, dtype=E.dtype, device=E.device)
    P = torch.zeros(masked.shape, dtype=torch.int8, device=E.device)
    front = masked[..., 0, :]
    starts = range(0, W, tile)
    for r0 in range(0, H - 1, K):
        N = min(K, H - 1 - r0)
        rows = torch.cat([front[..., None, :], masked[..., r0 + 1:r0 + N + 1, :]],
                         dim=-2)
        nxt = torch.empty_like(front)
        for w0 in range(0, len(starts), group):
            for g0 in starts[w0:w0 + group]:
                cols = torch.arange(g0 - Hh, g0 + tile + Hh, device=E.device)
                inside = (cols >= 0) & (cols < W)
                ext = torch.where(inside, rows[..., cols.clamp(0, W - 1)],
                                  inf)
                M = cumulative_energy(ext)
                par = parent_directions(M, tie)
                g1 = min(g0 + tile, W)
                own = slice(Hh, Hh + g1 - g0)
                P[..., r0 + 1:r0 + N + 1, g0:g1] = par[..., 1:, own]
                nxt[..., g0:g1] = M[..., -1, own]
        front = nxt
    return backtrack_blocked(P, front, R, tie)


def find_seam(E: torch.Tensor, delta_x: int = 1, rigidity: float = 0.0,
              tie: str = "leftmost") -> torch.Tensor:
    return backtrack(cumulative_energy(E, delta_x, rigidity), delta_x,
                     rigidity, tie)


def mask_energy(E: torch.Tensor, width, lo=0) -> torch.Tensor:
    """+inf outside the column window [lo, lo + width), so the DP never
    enters the dead region.  E: (..., H, W); `width` and `lo` are ints, or
    (B,) tensors giving each image of a (B, H, W) stack its own window."""
    col = torch.arange(E.shape[-1], device=E.device)
    if isinstance(width, torch.Tensor):  # one window per image
        width = width[..., None, None]
    if isinstance(lo, torch.Tensor):
        lo = lo[..., None, None]
    return torch.where((col >= lo) & (col < lo + width), E,
                       torch.tensor(math.inf, dtype=E.dtype, device=E.device))


def remove_seam(arr: torch.Tensor, seam: torch.Tensor) -> torch.Tensor:
    """Compact one pixel per row out of a fixed-width buffer.

    arr: (..., H, W[, C]); seam: (..., H) int, with arr's leading
    dimensions.  Column j of the result is arr[..., j] for j < seam and
    arr[..., j+1] for j >= seam; the last column wraps to column 0 and falls
    in the caller's dead region.
    """
    dim = seam.ndim  # the column dimension of arr
    W = arr.shape[dim]
    shifted = torch.roll(arr, -1, dims=dim)
    keep = torch.arange(W, device=arr.device) < seam[..., None]
    if arr.ndim > dim + 1:
        keep = keep[..., None]
    return torch.where(keep, arr, shifted)
