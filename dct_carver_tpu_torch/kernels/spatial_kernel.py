"""The per-shard kernels of the spatial route, each beside its plain version.

- `block_dp` (#16) and `block_dp_parts` (#17): K DP rows of every shard of
  a stack, from the halo-gathered message or from its four parts
  (`csrc/spatial_dp.cu`); counterparts of `dct_carver_tpu/pallas/
  spatial_dp_kernel.py::block_dp_rows` and `block_dp_parts_rows`.  Each
  shard's extended row runs as T column tiles, a CTA each, of Wt owned
  columns and Hg >= Kb ghost columns a side (`tile_plan`); a launch whose
  shards ran in more than one tile counts on its record's
  `tiled_blocks`.  Plain version: `scan_rows`, which with
  `delta_x`/`rigidity` other than (1, 0) is also the route's only DP, as
  the JAX package's scan is.
- `seg_walk` (#18): one backtrack segment, walked on the shard that owns
  its entry column (`csrc/spatial_dp.cu`); counterpart of `seg_walk_rows`.
  Plain version: `walk_rows`.
- `sharded_apply` (#19): the seam's compaction of luma, origcol and energy
  with the right neighbour's incoming column, the luma edge fill and the
  removed pixel's original column (`csrc/sharded_apply.cu`); counterpart
  of `sharded_apply_rows`.  Plain version: `apply_rows`.

Every function takes a stack of S column shards of one image that lie on
one device: shard s owns global columns [lo + s*Wl, lo + (s+1)*Wl), and a
halo-extended row holds global columns lo + s*Wl - Hh .. + Wl + 2*Hh - 1.
The logical width and the segment's entry column are one-element int32
tensors on the device, which the kernels read there.  A CUDA tensor with
`use_pallas` goes to the kernel, one launch for the stack, or raises; any
other tensor to the plain version.
"""

from __future__ import annotations

import math

import torch

from ..ops.dp import _argmin_tie, _rigidity_penalties, _shift_row, check_tie
from .build import Kernel, launch

__all__ = ["block_dp", "block_dp_parts", "seg_walk", "sharded_apply",
           "scan_rows", "walk_rows", "apply_rows", "tile_plan", "tile_bounds",
           "BLOCK_KERNEL", "PARTS_KERNEL", "WALK_KERNEL", "APPLY_KERNEL",
           "MAX_EXT_WIDTH"]

_SRC = "dct_carver_tpu_torch/csrc/"
_TPU = "dct_carver_tpu/pallas/spatial_dp_kernel.py:"
BLOCK_KERNEL = Kernel(name="block_dp", source=_SRC + "spatial_dp.cu",
                      replaces=_TPU + "106")
PARTS_KERNEL = Kernel(name="block_dp_parts", source=_SRC + "spatial_dp.cu",
                      replaces=_TPU + "179")
WALK_KERNEL = Kernel(name="seg_walk", source=_SRC + "spatial_dp.cu",
                     replaces=_TPU + "261")
APPLY_KERNEL = Kernel(name="sharded_apply", source=_SRC + "sharded_apply.cu",
                      replaces=_TPU + "348")
BLOCK_KERNEL.tiled_blocks = 0
PARTS_KERNEL.tiled_blocks = 0

# one block's shared memory (227 KB) holds at least one of the walk's
# chunks: _WALK_ROWS rows of the window's 2K+1 columns, aligned down to 4
# and padded to a multiple of 4 (csrc/spatial_dp.cu::walk_pitch); one block
# covers an extended row of at most 1024 threads of 32 columns
# (csrc/dp_rows.cuh::chunk_for)
_SMEM_LIMIT = 232448
_WALK_ROWS = 16
MAX_EXT_WIDTH = 32768
# the block DP's tiles: the columns one warp computes (8 a lane,
# csrc/spatial_dp.cu::kTileColumns), and the fewest owned columns a tile
TILE_SPAN = 256
TILE_MIN_OWNED = 64


def _origins(lo: int, S: int, Wl: int, device) -> torch.Tensor:
    """(S,) int64: each shard's first owned global column."""
    return lo + Wl * torch.arange(S, device=device)


def _stream(device) -> int:
    # naming the device skips torch's lookup of the current one, which
    # costs more host time than the launch
    return torch.cuda.current_stream(device).cuda_stream


def _rows(name: str, t: torch.Tensor, ndim: int, dtype, device) -> int:
    """Raise unless `t` is an `ndim`-D tensor of `dtype` on `device` whose
    rows are contiguous; return its stride between shards."""
    ok = (t.ndim == ndim and t.dtype == dtype and t.device == device
          and t.stride(-1) == 1
          and (ndim < 3 or t.shape[-2] < 2 or t.stride(-2) == t.shape[-1]))
    if not ok:
        raise ValueError(f"{name}: expected a {ndim}-D {dtype} tensor with "
                         f"contiguous rows on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} strides {t.stride()} on "
                         f"{t.device}")
    return t.stride(0)


def _scalar(name: str, t, device) -> int:
    """The device pointer of a one-element int32 tensor on `device`."""
    if not (isinstance(t, torch.Tensor) and t.numel() == 1
            and t.dtype == torch.int32 and t.device == device):
        raise ValueError(f"{name}: expected a one-element int32 tensor on "
                         f"{device}")
    return t.data_ptr()


def _out_rows(out, S: int, Kb: int, We: int, device) -> torch.Tensor:
    if out is None:
        return torch.empty((S, Kb, We), dtype=torch.float32, device=device)
    if tuple(out.shape) != (S, Kb, We):
        raise ValueError(f"out: expected {(S, Kb, We)}, got "
                         f"{tuple(out.shape)}")
    return out


def _check_width(We: int) -> None:
    if We > MAX_EXT_WIDTH:
        raise ValueError(f"block DP kernel: an extended row of {We} columns "
                         f"exceeds {MAX_EXT_WIDTH}, the most one block's "
                         "row covers")


def tile_plan(Kb: int, We: int) -> tuple[int, int, int]:
    """The block DP's schedule for Kb rows of a We-column extended row:
    (T, Wt, Hg), T tiles of the row (`tile_bounds`), each computed with
    Hg >= Kb ghost columns a side (Wt and Hg multiples of 4) by one warp of
    TILE_SPAN columns: the whole row where the warp holds it, else
    Wt = TILE_SPAN - 2*Hg >= 64 owned columns a tile.  (0, We, 0): one CTA
    a shard, where the warp holds no 64 owned columns and their ghosts
    (Kb > 96 on rows wider than TILE_SPAN).  The kernel takes T as its
    grid's width and checks only that the plan fits."""
    Hg = -(-Kb // 4) * 4
    if We <= TILE_SPAN:
        return 1, We, Hg
    Wt = TILE_SPAN - 2 * Hg
    if Wt < TILE_MIN_OWNED:
        return 0, We, 0
    return -(-(We - 2 * Hg) // Wt), Wt, Hg


def tile_bounds(We: int,
                plan: tuple[int, int, int]) -> list[tuple[int, int]]:
    """The owned columns [a, b) of each of a plan's T tiles of a We-column
    row (twin of `csrc/spatial_dp.cu::Tile`): Wt each, and the first and
    the last also the Hg columns their missing outer ghost zone frees, so
    that no tile computes more than Wt + 2*Hg columns."""
    T, Wt, Hg = plan
    cuts = [0, *(t * Wt + Hg for t in range(1, T)), We]
    return list(zip(cuts[:-1], cuts[1:]))


# ------------------------------------------------------------ block DP ----

def scan_rows(ext: torch.Tensor, col0: torch.Tensor, width, delta_x: int = 1,
              rigidity: float = 0.0) -> torch.Tensor:
    """The masked DP rows of a (S, Kb+1, We) message, row 0 the frontier:
    -> (S, Kb, We).  `col0`: (S,) the global column of each shard's extended
    column 0; `width`: the logical width (an int or a one-element tensor).
    Cells outside [0, width) are +inf, and so is every shifted-in cell.
    Candidate order and penalties as ops/dp.py::cumulative_energy; at (1, 0)
    this is the block kernels' op sequence, e + min(min(left, centre),
    right)."""
    S, Kb1, We = ext.shape
    cols = col0[:, None] + torch.arange(We, device=ext.device)
    valid = (cols >= 0) & (cols < width)
    inf = torch.tensor(math.inf, dtype=ext.dtype, device=ext.device)
    prev = torch.where(valid, ext[:, 0], inf)
    E = torch.where(valid[:, None], ext[:, 1:], inf)
    pen = _rigidity_penalties(delta_x, rigidity)
    out = torch.empty((S, Kb1 - 1, We), dtype=ext.dtype, device=ext.device)
    for r in range(Kb1 - 1):
        best = None
        for k, dx in enumerate(range(-delta_x, delta_x + 1)):
            cand = _shift_row(prev, dx)
            if pen[k] != 0.0:
                cand = cand + pen[k]
            best = cand if best is None else torch.minimum(best, cand)
        prev = E[:, r] + best
        out[:, r] = prev
    return out


def block_dp(msg: torch.Tensor, lo: int, width: torch.Tensor, Hh: int, *,
             out: torch.Tensor | None = None,
             use_pallas: bool = True) -> torch.Tensor:
    """#16: K DP rows of every shard from its halo-gathered (S, Kb+1, We)
    message (row 0 the frontier, We = Wl + 2*Hh) -> (S, Kb, We) f32, into
    `out` when given (rows contiguous, any stride between shards)."""
    S, Kb1, We = msg.shape
    Wl = We - 2 * Hh
    if not (msg.is_cuda and use_pallas):
        rows = scan_rows(msg, _origins(lo, S, Wl, msg.device) - Hh, width)
        return rows if out is None else out.copy_(rows)
    dev = msg.device
    if not msg.is_contiguous() or msg.dtype != torch.float32:
        raise ValueError("block_dp: msg must be a contiguous f32 tensor")
    _check_width(We)
    out = _out_rows(out, S, Kb1 - 1, We, dev)
    out_ss = _rows("out", out, 3, torch.float32, dev)
    plan = tile_plan(Kb1 - 1, We)
    with torch.cuda.device(dev):
        launch(BLOCK_KERNEL, "dc_block_dp", msg.data_ptr(), out.data_ptr(),
               out_ss, S, Kb1 - 1, Wl, Hh, lo, _scalar("width", width, dev),
               *plan, _stream(dev))
    BLOCK_KERNEL.tiled_blocks += plan[0] > 1
    return out


def block_dp_parts(prev: torch.Tensor, E_blk: torch.Tensor, lh: torch.Tensor,
                   rh: torch.Tensor, lo: int, width: torch.Tensor, *,
                   out: torch.Tensor | None = None,
                   use_pallas: bool = True) -> torch.Tensor:
    """#17: the rows of `block_dp` from the parts of the message: prev
    (S, Wl) the frontier, E_blk (S, Kb, Wl) the energy block, lh/rh
    (S, Kb+1, Hh) the neighbours' halo columns (row 0 the frontier's).
    The kernel reads each where it lies (rows contiguous, any stride
    between shards) and never builds the message."""
    S, Kb, Wl = E_blk.shape
    Hh = lh.shape[-1]
    We = Wl + 2 * Hh
    if lh.shape != (S, Kb + 1, Hh) or rh.shape != lh.shape \
            or prev.shape != (S, Wl):
        raise ValueError("block_dp_parts: prev (S, Wl), E_blk (S, Kb, Wl) "
                         "and lh/rh (S, Kb+1, Hh) expected")
    if not (E_blk.is_cuda and use_pallas):
        msg = torch.cat([lh, torch.cat([prev[:, None], E_blk], dim=1), rh],
                        dim=-1)
        rows = scan_rows(msg, _origins(lo, S, Wl, msg.device) - Hh, width)
        return rows if out is None else out.copy_(rows)
    dev = E_blk.device
    _check_width(We)
    prev_ss = _rows("prev", prev, 2, torch.float32, dev)
    e_ss = _rows("E_blk", E_blk, 3, torch.float32, dev)
    for name, h in (("lh", lh), ("rh", rh)):
        if not h.is_contiguous() or h.dtype != torch.float32 \
                or h.device != dev:
            raise ValueError(f"{name}: expected a contiguous f32 tensor on "
                             f"{dev}")
    out = _out_rows(out, S, Kb, We, dev)
    out_ss = _rows("out", out, 3, torch.float32, dev)
    plan = tile_plan(Kb, We)
    with torch.cuda.device(dev):
        launch(PARTS_KERNEL, "dc_block_dp_parts", prev.data_ptr(), prev_ss,
               E_blk.data_ptr(), e_ss, lh.data_ptr(), rh.data_ptr(),
               out.data_ptr(), out_ss, S, Kb, Wl, Hh, lo,
               _scalar("width", width, dev), *plan, _stream(dev))
    PARTS_KERNEL.tiled_blocks += plan[0] > 1
    return out


# ------------------------------------------------------------ seg walk ----

def walk_rows(rows: torch.Tensor, entry: torch.Tensor, lo: int, K: int,
              Hh: int, tie: str = "leftmost", delta_x: int = 1,
              rigidity: float = 0.0) -> torch.Tensor:
    """One backtrack segment: rows (S, Kb, We) of M, entry the global seam
    column below the last row -> (S, Kb) int32, the owner shard's global
    seam columns and 0 on every other shard.  The walk reads the
    (2*K*delta_x + 1)-column window around the entry and steps bottom-up
    with the `tie`-most penalised (2*delta_x + 1)-window rule of
    ops/dp.py::backtrack."""
    S, Kb, We = rows.shape
    d = delta_x
    dev = rows.device
    lo_s = _origins(lo, S, We - 2 * Hh, dev)
    j = entry.reshape(()).to(torch.int64)
    ww = 2 * K * d + 1
    start = (j - lo_s + Hh - K * d).clamp(0, We - ww)
    idx = start[:, None, None] + torch.arange(ww, device=dev)
    win = rows.gather(-1, idx.expand(S, Kb, ww))
    winp = torch.nn.functional.pad(win, (d, d), value=math.inf)
    pen = torch.tensor(_rigidity_penalties(d, rigidity), dtype=rows.dtype,
                       device=dev)
    offs = torch.arange(2 * d + 1, device=dev)
    jl = torch.full((S,), K * d, dtype=torch.int64, device=dev)
    seg = torch.empty((S, Kb), dtype=torch.int64, device=dev)
    for r in range(Kb - 1, -1, -1):
        w = winp[:, r].gather(-1, jl[:, None] + offs)
        if rigidity != 0.0:
            w = w + pen
        jl = jl - d + _argmin_tie(w, tie)
        seg[:, r] = jl
    owned = (j >= lo_s) & (j < lo_s + We - 2 * Hh)
    return torch.where(owned[:, None], seg + (j - K * d), 0).to(torch.int32)


def seg_walk(rows: torch.Tensor, entry: torch.Tensor, lo: int, K: int,
             Hh: int, *, tie: str = "leftmost",
             use_pallas: bool = True) -> torch.Tensor:
    """#18: `walk_rows` at delta_x = 1, rigidity = 0 (rows contiguous, any
    stride between shards)."""
    check_tie(tie)
    S, Kb, We = rows.shape
    if We < 2 * K + 1 or Kb > K:
        raise ValueError(f"seg_walk: a window of {2 * K + 1} columns and at "
                         f"most K={K} rows, got {tuple(rows.shape)}")
    if not (rows.is_cuda and use_pallas):
        return walk_rows(rows, entry, lo, K, Hh, tie)
    dev = rows.device
    pitch = (2 * K + 1 + 6) // 4 * 4
    if _WALK_ROWS * pitch * 4 > _SMEM_LIMIT:
        raise ValueError(f"seg_walk kernel: a {_WALK_ROWS}-row chunk of a "
                         f"{2 * K + 1}-column window exceeds one block's "
                         "shared memory")
    rows_ss = _rows("rows", rows, 3, torch.float32, dev)
    seg = torch.empty((S, Kb), dtype=torch.int32, device=dev)
    if Kb == 0:
        return seg
    with torch.cuda.device(dev):
        launch(WALK_KERNEL, "dc_seg_walk", rows.data_ptr(), rows_ss, S, Kb,
               We - 2 * Hh, Hh, K, lo, _scalar("entry", entry, dev),
               int(tie == "rightmost"), seg.data_ptr(), _stream(dev))
    return seg


# ------------------------------------------------------- sharded apply ----

def apply_rows(luma, origcol, energy, seam, edge, incoming, new_width,
               lo: int):
    """The compaction of every shard of a stack around the (H,) global
    `seam`: column j takes input column j before the seam and j+1 from it
    on, the last column the right neighbour's (`incoming` (S, H, 3): its
    luma, energy and origcol's bits as f32); luma columns from `new_width`
    on take the row's `edge` (H,).  Returns (luma', origcol', energy',
    orig (S, H) int32: the removed pixel's original column on its owner
    shard, 0 elsewhere)."""
    S, H, Wl = luma.shape
    cols = torch.arange(Wl, device=luma.device)
    col_g = _origins(lo, S, Wl, luma.device)[:, None, None] + cols
    keep = col_g < seam[:, None]
    last = cols == Wl - 1

    def compact(x, inc):
        shifted = torch.where(last, inc, torch.roll(x, -1, dims=-1))
        return torch.where(keep, x, shifted)

    luma_o = torch.where(col_g >= new_width, edge[:, None],
                         compact(luma, incoming[..., 0:1]))
    energy_o = compact(energy, incoming[..., 1:2])
    origcol_o = compact(origcol,
                        incoming[..., 2:3].contiguous().view(torch.int32))
    orig = torch.where(col_g == seam[:, None], origcol, 0).sum(
        -1, dtype=torch.int32)
    return luma_o, origcol_o, energy_o, orig


def sharded_apply(luma: torch.Tensor, origcol: torch.Tensor,
                  energy: torch.Tensor, seam: torch.Tensor, edge: torch.Tensor,
                  incoming: torch.Tensor, new_width: torch.Tensor, lo: int, *,
                  out=None, use_pallas: bool = True):
    """#19: `apply_rows` in one pass over (S, H, Wl) planes.  The kernel
    and the plain version both write into `out` when it is given (a (luma,
    origcol, energy) set of separate buffers); with None the kernel
    allocates one and the plain version returns new tensors."""
    S, H, Wl = luma.shape
    if not (luma.is_cuda and use_pallas):
        res = apply_rows(luma, origcol, energy, seam, edge, incoming,
                         new_width, lo)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return (*out, res[3])
    dev = luma.device
    for name, t, shape, dtype in (
            ("luma", luma, (S, H, Wl), torch.float32),
            ("origcol", origcol, (S, H, Wl), torch.int32),
            ("energy", energy, (S, H, Wl), torch.float32),
            ("seam", seam, (H,), torch.int32),
            ("edge", edge, (H,), torch.float32),
            ("incoming", incoming, (S, H, 3), torch.float32)):
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"sharded_apply: {name} must be a contiguous "
                             f"{dtype} {shape} tensor on {dev}")
    if S > 65535:
        raise ValueError(f"sharded_apply kernel: {S} shards exceed the "
                         "grid's 65535")
    if out is None:
        out = (torch.empty_like(luma), torch.empty_like(origcol),
               torch.empty_like(energy))
    for name, o, src in zip(("luma out", "origcol out", "energy out"), out,
                            (luma, origcol, energy)):
        if (o.shape != src.shape or o.dtype != src.dtype or o.device != dev
                or not o.is_contiguous() or o.data_ptr() == src.data_ptr()):
            raise ValueError(f"{name}: needs a separate contiguous buffer "
                             f"of shape {tuple(src.shape)}")
    orig = torch.empty((S, H), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        launch(APPLY_KERNEL, "dc_sharded_apply", luma.data_ptr(),
               origcol.data_ptr(), energy.data_ptr(), seam.data_ptr(),
               edge.data_ptr(), incoming.data_ptr(), out[0].data_ptr(),
               out[1].data_ptr(), out[2].data_ptr(), orig.data_ptr(), S, H,
               Wl, lo, _scalar("new_width", new_width, dev), _stream(dev))
    return (*out, orig)
