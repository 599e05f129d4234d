"""Find seams: the CUDA kernels `csrc/find_seam.cu` and
`csrc/find_seam_tiled.cu`, and their plain version `ops/dp.py`
(mask_energy + cumulative_energy + backtrack).

`find_seam` (one (H, W) plane) is the counterpart of
`dct_carver_tpu/pallas/dp_kernel.py::find_seam_pallas`; `find_seams` (a
(B, H, W) stack, one column window per image) of
`dct_carver_tpu/pallas/batch_dp_kernel.py::find_seams_vec`.  On a card
both ask `seam_route(B, W)` which kernel serves the shape: `find_seam.cu`
(one CTA an image, a plane as a batch of one) or the tiled kernel (one
warp a column tile, the counterpart of the streamed route `dp_forward` +
`dp_backtrack`), which every row wider than one thread block
(`MAX_WIDTH`) takes.  Each counts on its own record the launches its C
entry makes: `KERNEL` and `BATCH_KERNEL` one a call, `TILED_KERNEL` three
(the memset of the frontier and the finish's counters, the forward, the
finish; one for a one-row plane).  `TILED_KERNEL.blocked_finishes` counts
the tiled calls whose finish walked composed blocks of `FINISH_ROWS` rows
(`composes_blocks`), and `TILED_KERNEL.split_forwards` those whose forward
took the split schedule (`split_forward`: two helper warps beside each
tile's DP warp).
"""

from __future__ import annotations

import torch

from ..ops.dp import (check_tie, find_seam as find_seam_plain,
                      find_seam_tiled, mask_energy)
from .build import Kernel, check_plane, launch

__all__ = ["find_seam", "find_seams", "seam_route", "split_forward",
           "KERNEL", "BATCH_KERNEL", "TILED_KERNEL", "MAX_WIDTH",
           "FINISH_ROWS", "composes_blocks"]

KERNEL = Kernel(name="find_seam",
                source="dct_carver_tpu_torch/csrc/find_seam.cu",
                replaces="dct_carver_tpu/pallas/dp_kernel.py:348")
BATCH_KERNEL = Kernel(name="find_seams",
                      source="dct_carver_tpu_torch/csrc/find_seam.cu",
                      replaces="dct_carver_tpu/pallas/batch_dp_kernel.py:"
                               "139,171")
TILED_KERNEL = Kernel(name="find_seam_tiled",
                      source="dct_carver_tpu_torch/csrc/find_seam_tiled.cu",
                      replaces="dct_carver_tpu/pallas/dp_kernel.py:124,184")
TILED_KERNEL.blocked_finishes = 0
TILED_KERNEL.split_forwards = 0

# one CTA covers a row of at most 1024 threads of 32 columns each
# (csrc/dp_rows.cuh::chunk_for); wider rows take the tiled kernel
MAX_WIDTH = 32768
# The tiled kernel's geometry: TILE_C columns a lane, so a warp-tile's
# extended row of TILE_W owned columns and a halo of TILE_K (rounded up to
# 4) columns a side fits 32 * TILE_C columns; TILE_K rows a block;
# TILE_WARPS warp-tiles a CTA in the one-warp schedule (`csrc/
# find_seam_tiled.cu`: one warp a tile stages its energy and writes its
# parents itself; in the split schedule a CTA a tile, whose DP warp keeps
# only the recurrence while two helper warps do the rest).  From
# chip_smoke.py's geometry sweep (phase 1c) on an NVIDIA H100 80GB HBM3 at
# 700.00 W: (4, 64, 32), split, takes the least device time summed over
# its shapes, and over the benchmark's three planes alone, 43-44 % less
# than one warp a tile.  PERF.md §6 holds the table.
TILE_C = 4
TILE_K = 32
TILE_W = 64
TILE_WARPS = 1
# The split schedule serves stacks of at most SPLIT_MAX_TILES tiles (B *
# ceil(W / TILE_W)): as many of its CTAs as are resident at once on that
# card (132 SMs, four of 48 KB each).  Past it a CTA runs several tiles one
# after the other, and one warp a tile wins: the split sweep (phase 1c)
# timed the split forward 20 % faster at 528 tiles and 22 % slower at 529.
SPLIT_MAX_TILES = 528
# seam_route's thresholds, from chip_smoke.py's width sweep (phase 1c) on
# the same card.  One image: the tiled kernel beats find_seam.cu at every
# width swept, ROUTE_MIN_WIDTH (64) to 32768 columns (narrower rows were not
# measured).  A stack: at 1024, 1920 and 4096 columns it wins up to
# ROUTE_MAX_BATCH (32) images; at 64 images (one warp a tile there) it won
# at 1024 and 1920 columns by 16 % and 2 % and lost at 4096 by 22 %, within
# the 2x that find_seam.cu's times move between processes, and from 128 on
# it loses.  PERF.md §6 holds the sweep, with the run it comes from.
ROUTE_MIN_WIDTH = 64
ROUTE_MAX_BATCH = 32
# the tiled kernel's finish walks the parents in blocks of FINISH_ROWS
# rows (`csrc/find_seam_tiled.cu`'s kFinishRows, `ops/dp.py::
# backtrack_blocked`'s R); a jump over a block is one int8.  It composes
# the blocks of a stack whose B * W is at most FINISH_COMPOSE_COLUMNS (its
# kComposeColumns) and walks the others' rows block after block.
FINISH_ROWS = 64
FINISH_COMPOSE_COLUMNS = 48 * 1024


def seam_route(B: int, W: int) -> str:
    """The kernel that finds the seams of a (B, H, W) stack on a card:
    "tiled" for rows wider than one thread block, and below that where the
    tiled kernel's device time beats find_seam.cu's; else "find_seam"."""
    if W > MAX_WIDTH:
        return "tiled"
    if W >= ROUTE_MIN_WIDTH and B <= ROUTE_MAX_BATCH:
        return "tiled"
    return "find_seam"


def split_forward(B: int, W: int, tile: int = TILE_W) -> bool:
    """Whether the tiled forward of a (B, H, W) stack with `tile` owned
    columns a tile takes the split schedule: at most SPLIT_MAX_TILES
    tiles.  Past that, one warp a tile."""
    return B * -(-W // tile) <= SPLIT_MAX_TILES


def tile_halo(K: int) -> int:
    """The tiled kernel's halo columns a side for K rows a block: K
    rounded up to 4, so every tile starts on a 16-byte boundary."""
    return (K + 3) // 4 * 4


def check_tile_geometry(tile: int, K: int, chunk: int = TILE_C,
                        warps: int = TILE_WARPS, split: bool = False) -> None:
    """Raise ValueError unless the tiled kernel runs this geometry: `tile`
    owned columns (a multiple of 4), K >= 1 rows a block whose halo
    (`tile_halo(K)`) reaches no further than the neighbouring tiles (halo
    <= tile), an extended row of tile + 2 * halo within one warp's 32 *
    `chunk` columns (chunk 4 or 8), and 1..8 warp-tiles a CTA, one in the
    split schedule (a CTA a tile)."""
    halo = tile_halo(K)
    if chunk not in (4, 8) or tile < 4 or tile % 4 or K < 1 \
            or halo > tile or tile + 2 * halo > 32 * chunk \
            or not 1 <= warps <= (1 if split else 8):
        raise ValueError(
            f"tiled find_seam: tile={tile} (a multiple of 4), K={K} >= 1 "
            f"(halo {halo} <= tile), chunk={chunk} (4 or 8) with tile + "
            f"2 * halo <= 32 * chunk, and warps={warps} in 1..8, 1 for "
            f"the split schedule (split={split})")


def parent_pitch(W: int) -> int:
    """The row pitch of the kernel's int8 parents scratch: W rounded up to
    4, so each thread stores its parents four to a 32-bit word."""
    return (W + 3) // 4 * 4


def composes_blocks(B: int, H: int, W: int) -> bool:
    """Whether the tiled kernel's finish composes the blocks of a (B, H, W)
    stack: more than one block of rows, and B * W columns that composing
    pays for."""
    return H - 1 > FINISH_ROWS and B * W <= FINISH_COMPOSE_COLUMNS


def tiled_scratch_cells(B: int, H: int, W: int, K: int = TILE_K) -> int:
    """The 64-bit cells of the tiled kernel's scratch (`front` of
    `csrc/find_seam_tiled.cu`'s C entry): the frontier's ceil((H - 1) / K)
    slices of B x W cells, the finish's cell an image and its ticket cell,
    then, from a 16-byte boundary, the finish's jumps, B x ceil((H - 1) /
    FINISH_ROWS) rows of W rounded up to 16 bytes, when there is more than
    one block of rows."""
    if H < 2:
        return 1
    cells = -(-(H - 1) // K) * B * W + B + 1
    blocks = -(-(H - 1) // FINISH_ROWS)
    jumps = B * blocks * (-(-W // 16) * 16) if blocks > 1 else 0
    return cells + cells % 2 + -(-jumps // 8)


def _pointer_args(width, lo, dev) -> tuple[list, list]:
    """The C entries' (lo[B], width[B]) pointers and (lo0, width0) ints:
    a (B,) int32 tensor on `dev` goes as a pointer (its int 0), an int as
    an int (a null pointer)."""
    ptrs, scalars = [], []
    for name, v in (("lo", lo), ("width", width)):
        if isinstance(v, torch.Tensor):
            check_plane(name, v, torch.int32, dev)
            ptrs.append(v.data_ptr())
            scalars.append(0)
        else:
            ptrs.append(None)
            scalars.append(int(v))
    return ptrs, scalars


def _find_seams_cuda(kernel: Kernel, E: torch.Tensor, width, lo,
                     tie: str) -> torch.Tensor:
    """(B, H, W) -> (B, H) seams on the card, through the kernel that
    `seam_route` picks (`kernel` is find_seam.cu's record to count on).
    `width`/`lo` are ints shared by every image, or (B,) int32 tensors on
    E's device."""
    if seam_route(E.shape[0], E.shape[-1]) == "tiled":
        return _find_seams_tiled(E, width, lo, tie)
    return _find_seams_one_cta(kernel, E, width, lo, tie)


def _find_seams_one_cta(kernel: Kernel, E: torch.Tensor, width, lo,
                        tie: str) -> torch.Tensor:
    """(B, H, W) -> (B, H) seams through find_seam.cu, one launch, whatever
    `seam_route` says (W <= MAX_WIDTH); counted on `kernel`."""
    dev = E.device
    check_plane("energy", E, torch.float32, dev)
    B, H, W = E.shape
    if W > MAX_WIDTH:
        raise ValueError(f"find_seam.cu takes rows of at most {MAX_WIDTH} "
                         f"columns, got {W}")
    ptrs, scalars = _pointer_args(width, lo, dev)
    parents = torch.empty((B, H, parent_pitch(W)), dtype=torch.int8,
                          device=dev)
    seams = torch.empty((B, H), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        launch(kernel, "dc_find_seams", E.data_ptr(), parents.data_ptr(),
               seams.data_ptr(), B, H, W, *ptrs, *scalars,
               int(tie == "rightmost"), torch.cuda.current_stream().cuda_stream)
    return seams


def _find_seams_tiled(E: torch.Tensor, width, lo, tie: str, *,
                      tile: int = TILE_W, K: int = TILE_K,
                      chunk: int = TILE_C, warps: int = TILE_WARPS,
                      split: bool | None = None,
                      max_warps: int = 0) -> torch.Tensor:
    """(B, H, W) -> (B, H) int32 seams through the tiled kernel at any
    width (`width`/`lo` as `_find_seams_cuda`), with the geometry of
    `check_tile_geometry`; on a CPU tensor its plain algorithm
    (`ops/dp.py::find_seam_tiled`).  `split` None takes the forward's
    schedule from `split_forward` (then `warps` counts only for the
    one-warp schedule).  `max_warps` caps the tiles' DP warps launched (0:
    as many as are resident), so that tests can force several tiles a
    warp; the plain algorithm then groups the tiles as the kernel's warps
    do.  The route picks the default geometry; the rest is for tests and
    measurements."""
    B, H, W = E.shape
    check_tile_geometry(tile, K, chunk, warps, bool(split))
    if split is None:
        split = split_forward(B, W, tile)
        warps = 1 if split else warps
    if max_warps < 0:
        raise ValueError(f"max_warps must be >= 0, got {max_warps}")
    if not E.is_cuda:
        group = -(-B * -(-W // tile) // max_warps) if max_warps else 1
        return find_seam_tiled(E, width, lo, tie, tile=tile, K=K,
                               group=group, R=FINISH_ROWS).to(torch.int32)
    dev = E.device
    check_plane("energy", E, torch.float32, dev)
    ptrs, scalars = _pointer_args(width, lo, dev)
    parents = torch.empty((B, H, parent_pitch(W)), dtype=torch.int8,
                          device=dev)
    # the frontier (each block's last row as (value, block) cells) and the
    # finish's counters and jumps
    front = torch.empty(tiled_scratch_cells(B, H, W, K), dtype=torch.int64,
                        device=dev)
    seams = torch.empty((B, H), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        launch(TILED_KERNEL, "dc_find_seams_tiled", E.data_ptr(),
               parents.data_ptr(), seams.data_ptr(), front.data_ptr(),
               B, H, W, *ptrs, *scalars,
               int(tie == "rightmost"), chunk, tile, K, warps, int(split),
               max_warps, torch.cuda.current_stream().cuda_stream,
               launches=3 if H > 1 else 1)
    count_tiled_call(B, H, W, split)
    return seams


def count_tiled_call(B: int, H: int, W: int, split: bool) -> None:
    """Count a tiled call of a (B, H, W) stack on TILED_KERNEL's counters
    beside its launches: `blocked_finishes` where its finish composes
    blocks, `split_forwards` where a forward ran (H > 1) on the split
    schedule."""
    TILED_KERNEL.blocked_finishes += composes_blocks(B, H, W)
    TILED_KERNEL.split_forwards += H > 1 and split


def find_seam(E: torch.Tensor, width: int, *, tie: str = "leftmost",
              use_pallas: bool = True) -> torch.Tensor:
    """Masked find-seam over the live columns [0, width): (H, W) energy ->
    (H,) int32 seam.  A CUDA tensor with `use_pallas` goes to the kernel
    that `seam_route` picks; any other tensor to the plain version."""
    check_tie(tie)
    if E.ndim != 2:
        raise ValueError(f"energy must be (H, W), got {tuple(E.shape)}")
    if not 1 <= width <= E.shape[1]:
        raise ValueError(f"width {width} outside [1, {E.shape[1]}]")
    if E.is_cuda and use_pallas:
        return _find_seams_cuda(KERNEL, E[None], int(width), 0, tie)[0]
    return find_seam_plain(mask_energy(E, width), tie=tie).to(torch.int32)


def _check_windows(width, lo, B: int, W: int, device) -> None:
    """Raise unless every image's window [lo, lo + width) is non-empty and
    inside [0, W).  Tensors are (B,) int32 on `device`; checking their
    values waits for the device."""
    tensors = [v for v in (width, lo) if isinstance(v, torch.Tensor)]
    for v in tensors:
        if v.shape != (B,) or v.dtype != torch.int32 or v.device != device:
            raise ValueError(f"width/lo must be ints or ({B},) int32 tensors "
                             f"on {device}, got {tuple(v.shape)} {v.dtype} "
                             f"on {v.device}")
    w = width.to(torch.int64) if isinstance(width, torch.Tensor) else width
    o = lo.to(torch.int64) if isinstance(lo, torch.Tensor) else lo
    ok = (w >= 1) & (o >= 0) & (o + w <= W)
    if not bool(torch.as_tensor(ok).all()):
        raise ValueError(f"every window [lo, lo + width) must be non-empty "
                         f"and inside [0, {W})")


def find_seams(E: torch.Tensor, width, lo=0, *, tie: str = "leftmost",
               use_pallas: bool = True) -> torch.Tensor:
    """Masked find-seam of each image of a stack over its own column window
    [lo_b, lo_b + width_b): (B, H, W) energy -> (B, H) int32 seams, the
    seam each image gets alone.  `width` and `lo` are ints shared by every
    image (the carve loop's case, which never waits for the device) or (B,)
    int32 tensors.  A CUDA tensor with `use_pallas` goes to the kernel that
    `seam_route` picks, one call for the batch; any other tensor to the
    plain version."""
    check_tie(tie)
    if E.ndim != 3:
        raise ValueError(f"energy must be (B, H, W), got {tuple(E.shape)}")
    _check_windows(width, lo, E.shape[0], E.shape[2], E.device)
    if E.is_cuda and use_pallas:
        return _find_seams_cuda(BATCH_KERNEL, E, width, lo, tie)
    return find_seam_plain(mask_energy(E, width, lo), tie=tie).to(torch.int32)
