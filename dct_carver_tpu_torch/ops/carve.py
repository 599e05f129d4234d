"""The multi-seam carve loop — fixed-width buffers, logical width.

Counterpart of `dct_carver_tpu/ops/carve.py`.  Buffers keep the original
width W; `width` (a Python int) tracks the logical width, and columns
>= width form a dead region that is (a) edge-filled in the luma plane, so
window clamping matches the reference's border behaviour
(`src/render.c:122-132`), and (b) masked to +inf by the DP.

Seam bookkeeping matches liblqr's visibility maps (`src/render.c:204-240`):
`vmap[y, x_original] = k` if the pixel was removed by the k-th seam, else 0.

The loop carves one (H, W) plane or a (B, H, W) stack of images of one size
(the batch route, `parallel/mesh.py`): every buffer then carries the leading
B, each step is one launch for the whole batch, and every image loses one
seam a step, so `width` stays one Python int.  A plane runs the same code
as a stack of one.

Each seam runs four steps, each one kernel on CUDA tensors (`use_pallas`)
and its plain PyTorch version otherwise: find the seam
(`kernels/dp_kernel.py`: `find_seam` for a plane, `find_seams` for a
stack), record it in the vmap (plain gather + scatter),
compact the buffers around it (`kernels/apply_kernel.py`), and recompute
the energy in a strip around it (`kernels/strip_kernel.py`).  The seam loop
is a Python loop that never waits for the device.

Strip update: a pixel's energy can only change if its window overlaps a
changed column, and the seam drifts <= delta_x columns a row, so row i
recomputes the `strip_w` columns from clip(seam_i - half, 0, W - strip_w).
Every recomputed value goes through the same energy chain as a full
recompute, so strip == full bit for bit (docs/PARITY.md S5).

A plugged energy (`energy_fn`, an `ops/energy_fn.py::EnergyFunction`)
replaces the DCT: its first map is `energy_fn.energy_map`, and its strip
update is three steps — gather each row's band of the compacted luma
(`kernels/strip_kernel.py::strip_gather`), the energy's own `bands_fn` on
the bands, and a scatter of the strips into the compacted energy
(`strip_scatter`).  The window size is then the energy's `n`, not
`blocksize`, for the strip extent and every guard.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .dct import energy_from_bands, window_offset
from .dp import check_tie, find_seam as find_seam_plain, mask_energy

__all__ = ["CarveState", "ShardOffset", "make_state", "carve_n_seams",
           "carve_seams", "strip_fits", "full_energy_map",
           "reconstruct_removed", "reconstruct_enlarged"]


class CarveState(NamedTuple):
    """Every tensor is (H, W) for one image or (B, H, W) for a stack."""
    luma: torch.Tensor     # float — current image, dead region edge-filled
    origcol: torch.Tensor  # int32 — original column of each current pixel
    vmap: torch.Tensor     # int32 — visibility map in ORIGINAL coordinates
    width: int             # logical width, shared by a stack's images
    energy: torch.Tensor   # float32 — current energy (dead region garbage)


def make_state(luma: torch.Tensor, width: int | None = None) -> CarveState:
    """`luma`: (H, W) or (B, H, W).  `width`: logical width when the buffer
    carries right padding (the pad columns must replicate the last live
    column)."""
    W = luma.shape[-1]
    dev = luma.device
    return CarveState(
        luma=luma,
        origcol=torch.arange(W, dtype=torch.int32, device=dev)
        .expand(luma.shape).contiguous(),
        vmap=torch.zeros(luma.shape, dtype=torch.int32, device=dev),
        width=W if width is None else int(width),
        energy=torch.zeros(luma.shape, dtype=torch.float32, device=dev),
    )


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


def _edge_fill(luma: torch.Tensor, width: int) -> torch.Tensor:
    """Replicate column width-1 into the dead region (border clamp)."""
    col = torch.arange(luma.shape[-1], device=luma.device)
    return torch.where(col < width, luma, luma[..., width - 1 : width])


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


def _update_strip_fn(luma: torch.Tensor, energy: torch.Tensor,
                     seam: torch.Tensor, energy_fn, delta_x: int,
                     use_pallas: bool,
                     shard: ShardOffset | None = None) -> torch.Tensor:
    """The strip update of a plugged energy, in place: gather the bands
    (kernel #11's counterpart), run `energy_fn.bands_fn` on them, scatter
    the strips (kernel #12's counterpart).  `shard`: as `_recompute_strip`."""
    from ..kernels.strip_kernel import strip_gather, strip_scatter

    n = energy_fn.n
    bands = strip_gather(luma, seam, n, delta_x=delta_x,
                         use_pallas=use_pallas, shard=shard)
    strip = energy_fn.bands_fn(bands.reshape(-1, *bands.shape[-2:]))
    strip = strip.to(torch.float32).reshape(*bands.shape[:-2], -1)
    return strip_scatter(energy, strip.contiguous(), seam, n,
                         delta_x=delta_x, use_pallas=use_pallas, shard=shard)


def full_energy_map(luma: torch.Tensor, blocksize: int, edges, textures,
                    center: str = "carve", use_pallas: bool = True,
                    energy_fn=None) -> torch.Tensor:
    """Full-image energy of a (H, W) plane or (B, H, W) stack, f32: the
    energy kernel on CUDA tensors, the plain version otherwise.  With a
    plugged `energy_fn` its own `energy_map` runs instead (plain torch, as
    the JAX package runs it in XLA)."""
    from ..kernels.energy_kernel import dct_energy

    if energy_fn is not None:
        return energy_fn.energy_map(luma, center).to(torch.float32)
    return dct_energy(luma, blocksize, edges, textures, center=center,
                      use_pallas=use_pallas)


def _one_seam(state: CarveState, k: int, blocksize: int, edges, textures,
              strip_update: bool, use_pallas: bool = True, delta_x: int = 1,
              rigidity: float = 0.0, tie: str = "leftmost",
              out=None, energy_fn=None) -> CarveState:
    """Remove the k-th seam (from every image of a stack).  Updates
    `state.vmap` in place; with kernels the compacted buffers are written
    into `out` (a (luma, origcol, energy) set the size of the state's) when
    given."""
    from ..kernels.apply_kernel import apply_seam
    from ..kernels.dp_kernel import find_seam, find_seams
    from ..kernels.strip_kernel import strip_update as update_strip

    if delta_x == 1 and rigidity == 0.0:
        find = find_seams if state.energy.ndim == 3 else find_seam
        seam = find(state.energy, state.width, tie=tie, use_pallas=use_pallas)
    else:
        seam = find_seam_plain(mask_energy(state.energy, state.width),
                               delta_x, rigidity, tie).to(torch.int32)

    # record the k-th seam at original coordinates (src/render.c:204-240)
    orig = state.origcol.gather(-1, seam[..., None].to(torch.int64))
    state.vmap.scatter_(-1, orig.to(torch.int64), k)

    luma, origcol, energy = apply_seam(state.luma, state.origcol,
                                       state.energy, seam, state.width,
                                       out=out, use_pallas=use_pallas)
    new_width = state.width - 1
    if not strip_update:
        energy = full_energy_map(luma, blocksize, edges, textures,
                                 use_pallas=use_pallas, energy_fn=energy_fn)
    elif energy_fn is not None:
        _update_strip_fn(luma, energy, seam, energy_fn, delta_x, use_pallas)
    else:
        update_strip(luma, energy, seam, blocksize, edges, textures,
                     delta_x=delta_x, use_pallas=use_pallas)
    return CarveState(luma, origcol, state.vmap, new_width, energy)


def strip_fits(W: int, blocksize: int, delta_x: int = 1,
               energy_fn=None) -> bool:
    """Whether the per-row strip fits a buffer `W` wide; narrower buffers
    recompute the full map every seam.  The window is the plugged energy's
    `n` when there is one, else `blocksize`."""
    n_eff = energy_fn.n if energy_fn is not None else blocksize
    return W >= _strip_extent(n_eff, delta_x)[1]


def carve_seams(state: CarveState, first: int, count: int, blocksize: int,
                edges, textures, strip_update: bool = True,
                use_pallas: bool = True, delta_x: int = 1,
                rigidity: float = 0.0, tie: str = "leftmost",
                energy_fn=None) -> CarveState:
    """Remove seams first+1 .. first+count from `state`, whose buffers the
    carve owns (the kernels write into a spare set, and the sets swap every
    seam).  Never waits for the device."""
    spare = None
    for k in range(first + 1, first + count + 1):
        new = _one_seam(state, k, blocksize, edges, textures, strip_update,
                        use_pallas, delta_x, rigidity, tie, out=spare,
                        energy_fn=energy_fn)
        spare = (state.luma, state.origcol, state.energy)
        state = new
    return state


def carve_n_seams(luma: torch.Tensor, n_seams: int, blocksize: int, edges,
                  textures, strip_update: bool = True,
                  use_pallas: bool = True, delta_x: int = 1,
                  rigidity: float = 0.0, tie: str = "leftmost",
                  energy_fn=None) -> CarveState:
    """Remove `n_seams` vertical seams from a (H, W) luma plane, or from
    each plane of a (B, H, W) stack.

    Returns the final CarveState; the caller reconstructs outputs from
    `vmap` (`reconstruct_removed` / `reconstruct_enlarged`).  The first
    energy map is computed in full; later seams use strip updates when
    enabled.  `use_pallas`: hand-written kernels for CUDA tensors (the plain
    versions run for CPU tensors, or on the card when False).
    `delta_x`/`rigidity` other than (1, 0) take the plain DP.  `energy_fn`:
    a plugged `EnergyFunction` replacing the DCT energy (`blocksize`,
    `edges` and `textures` are then unused).
    """
    check_tie(tie)
    if luma.ndim not in (2, 3):
        raise ValueError(f"luma must be (H, W) or (B, H, W), got "
                         f"{tuple(luma.shape)}")
    W = luma.shape[-1]
    if delta_x < 1:
        raise ValueError(f"delta_x must be >= 1, got {delta_x}")
    if not 0 <= n_seams < W:
        raise ValueError(f"cannot remove {n_seams} seams from width {W}")
    state = make_state(luma.clone())
    state = state._replace(energy=full_energy_map(
        state.luma, blocksize, edges, textures, use_pallas=use_pallas,
        energy_fn=energy_fn))
    # strips wider than the buffer would index out of bounds: full
    # recompute for tiny images
    strip_update = strip_update and strip_fits(W, blocksize, delta_x,
                                               energy_fn)
    return carve_seams(state, 0, n_seams, blocksize, edges, textures,
                       strip_update, use_pallas, delta_x, rigidity, tie,
                       energy_fn)


def reconstruct_removed(image: torch.Tensor, vmap: torch.Tensor,
                        n_seams: int) -> torch.Tensor:
    """Apply all removal seams in `vmap` to the full-channel image.

    image: (H, W[, C]) with vmap (H, W), or a stack (B, H, W[, C]) with
    vmaps (B, H, W); returns (..., H, W-n_seams[, C]).  A stable argsort
    keeps the surviving columns in order (one gather per carve).
    """
    dim = vmap.ndim - 1  # the column dimension
    W = image.shape[dim]
    removed = (vmap > 0).to(torch.uint8)
    order = torch.argsort(removed, dim=-1, stable=True)[..., : W - n_seams]
    if image.ndim > vmap.ndim:
        order = order[..., None].expand(*order.shape, image.shape[-1])
    return torch.gather(image, dim, order)


def reconstruct_enlarged(image: torch.Tensor, vmap: torch.Tensor,
                         n_seams: int) -> torch.Tensor:
    """Insert a duplicate after every seam pixel (liblqr enlargement).

    Inserted value = mean of the seam pixel and its right neighbour
    (border-clamped); round-half-up for integer dtypes.  A stack (B, H,
    W[, C]) with vmaps (B, H, W) is enlarged image by image.
    """
    if vmap.ndim == 3:
        return torch.stack([reconstruct_enlarged(im, vm, n_seams)
                            for im, vm in zip(image, vmap)])
    H, W = image.shape[:2]
    dev = image.device
    s = (vmap > 0).to(torch.int64)
    offs = torch.cumsum(s, dim=1) - s                    # exclusive cumsum
    pos = torch.arange(W, device=dev)[None, :] + offs    # out position of originals
    rows = torch.arange(H, device=dev)[:, None].expand(H, W)

    nbr = torch.cat([image[:, 1:], image[:, -1:]], dim=1)
    if image.dtype.is_floating_point:
        avg = (image + nbr) / 2
    else:
        avg = torch.div(image.to(torch.int32) + nbr.to(torch.int32) + 1, 2,
                        rounding_mode="floor").to(image.dtype)

    seam_px = s == 1
    dup_pos = torch.where(seam_px, pos + 1, pos)
    if image.ndim == 3:
        seam_px = seam_px[..., None]
    dup_val = torch.where(seam_px, avg, image)
    out = torch.zeros((H, W + n_seams) + tuple(image.shape[2:]),
                      dtype=image.dtype, device=dev)
    out[rows, pos] = image
    out[rows, dup_pos] = dup_val
    return out
