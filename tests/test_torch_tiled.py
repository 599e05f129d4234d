"""The tiled find-seam (plain PyTorch, CPU) against the JAX package.

`csrc/find_seam_tiled.cu` cuts rows over column tiles with halos, one
warp a tile, and runs K DP rows a block from a frontier that holds each
block's last row, all blocks in one launch; a warp may take several
adjacent tiles.
`ops/dp.py::find_seam_tiled` is that algorithm in plain PyTorch; it must
give the seams of the JAX scan DP and of the Pallas kernels (interpret
mode), bit for bit, with small tiles and tiles of one warp's width, on
ragged last tiles, with K not dividing H and halos as wide as the tiles,
in column windows, along tile edges and borders, per image of a stack and
with the tiles grouped as the kernel's warps take them.  The forward's
two schedules (one warp a tile, or the split one: two helper warps
beside each tile's DP warp) compute the same values, so the plain
algorithm holds both; `split_forward`, which picks the schedule,
`seam_route`,
the kernel's geometry check and the `split_forwards` count are held here
too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_carver_tpu.ops import dp as jdp
from dct_carver_tpu.pallas.batch_dp_kernel import find_seams_vec
from dct_carver_tpu.pallas.dp_kernel import find_seam_pallas
from dct_carver_tpu_torch import kernels
from dct_carver_tpu_torch.kernels import dp_kernel
from dct_carver_tpu_torch.kernels.dp_kernel import (
    FINISH_ROWS, MAX_WIDTH, SPLIT_MAX_TILES, TILE_C, TILE_K, TILE_W,
    TILE_WARPS, TILED_KERNEL, _find_seams_tiled, check_tile_geometry,
    count_tiled_call, find_seam, find_seams, seam_route, split_forward,
    tile_halo)
from dct_carver_tpu_torch.ops import dp as tdp

H = 24
TIES = ("leftmost", "rightmost")


def _energy(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random(shape, dtype=np.float32)
    # {0, 1/2}: most cells tie with a neighbour
    return (rng.integers(0, 2, shape) / 2).astype(np.float32)


def _scan(E, width, lo, tie):
    """JAX's scan DP on the energy masked to [lo, lo + width)."""
    masked = tdp.mask_energy(torch.from_numpy(E), width, lo).numpy()
    return np.asarray(jdp.find_seam(jnp.asarray(masked), tie=tie))


def _tiled(E, width, lo, tie, tile, K):
    return tdp.find_seam_tiled(torch.from_numpy(E), width, lo, tie,
                               tile=tile, K=K).numpy()


# W = 200 = 4 tiles of 48 and a ragged tile of 8; K = 8 (halo 8) and K = 5
# (halo rounded up to 8, so 3 rows more than it needs)
@pytest.mark.parametrize("lo,width", [(0, 200), (37, 120)])
@pytest.mark.parametrize("K", [8, 5])
@pytest.mark.parametrize("kind", ["random", "tie-heavy"])
@pytest.mark.parametrize("tie", TIES)
def test_tiled_equals_jax_scan(tie, kind, K, lo, width):
    E = _energy(kind, (H, 200), 11 if kind == "random" else 12)
    got = _tiled(E, width, lo, tie, 48, K)
    np.testing.assert_array_equal(got, _scan(E, width, lo, tie))
    assert got.dtype == np.int32 and got.shape == (H,)
    assert (got >= lo).all() and (got < lo + width).all()


# W = 256 (the Pallas kernel wants W % 128 == 0): 5 tiles of 48, one of 16
@pytest.mark.parametrize("lo,width", [(0, 256), (50, 181)])
@pytest.mark.parametrize("K", [8, 5])
@pytest.mark.parametrize("tie", TIES)
def test_tiled_equals_pallas_fused(tie, K, lo, width):
    E = _energy("tie-heavy", (H, 256), 13)
    want = np.asarray(find_seam_pallas(jnp.asarray(E), width, lo,
                                       interpret=True, tie=tie))
    np.testing.assert_array_equal(_tiled(E, width, lo, tie, 48, K), want)


@pytest.mark.parametrize("col", [0, 47, 48, 95, 96, 199])
@pytest.mark.parametrize("tie", TIES)
def test_tiled_seam_along_a_tile_edge_or_border(tie, col):
    # columns 47/48 and 95/96 are the last and first owned columns of
    # neighbouring tiles; 0 and 199 the image's borders
    E = np.ones((H, 200), np.float32)
    E[:, col] = 0
    got = _tiled(E, 200, 0, tie, 48, 5)
    assert (got == col).all()
    np.testing.assert_array_equal(got, _scan(E, 200, 0, tie))


@pytest.mark.parametrize("kind", ["random", "tie-heavy"])
@pytest.mark.parametrize("tie", TIES)
def test_tiled_stack_with_per_image_windows(tie, kind):
    B, Hb, Wb = 4, 24, 256
    E = _energy(kind, (B, Hb, Wb), 14 if kind == "random" else 15)
    width = np.array([Wb, 200, 3, 17], np.int32)
    lo = np.array([0, 37, 253, 0], np.int32)
    got = _find_seams_tiled(torch.from_numpy(E), torch.from_numpy(width),
                            torch.from_numpy(lo), tie, tile=48, K=8)
    assert got.dtype == torch.int32 and got.shape == (B, Hb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(find_seams_vec(
        jnp.asarray(E), jnp.asarray(width), jnp.asarray(lo), interpret=True,
        tie=tie)))


@pytest.mark.parametrize("h,w,tile,K", [(1, 50, 8, 3), (2, 50, 8, 3),
                                        (23, 13, 4, 1), (40, 97, 12, 4),
                                        (30, 61, 60, 64)])
@pytest.mark.parametrize("tie", TIES)
def test_tiled_shapes_equal_the_plain_dp(tie, h, w, tile, K):
    # one row (no launch of rows), one DP row, one-column tiles with K = 1,
    # a halo wider than the tiles, a block taller than the plane
    E = _energy("tie-heavy", (h, w), 16)
    want = tdp.find_seam(tdp.mask_energy(torch.from_numpy(E), w - 2, 1),
                         tie=tie).numpy()
    np.testing.assert_array_equal(_tiled(E, w - 2, 1, tie, tile, K), want)


def test_wide_rows_on_the_cpu_take_the_plain_version():
    # no width cap: a row wider than one block carves on the CPU, and
    # neither kernel counts a launch
    E = torch.from_numpy(_energy("random", (3, MAX_WIDTH + 5), 17))
    kernels.reset_launches()
    got = find_seam(E, MAX_WIDTH + 1)
    want = tdp.find_seam(tdp.mask_energy(E, MAX_WIDTH + 1)).to(torch.int32)
    assert torch.equal(got, want)
    assert torch.equal(find_seams(E[None], MAX_WIDTH + 1)[0], want)
    assert torch.equal(_find_seams_tiled(E[None], MAX_WIDTH + 1, 0,
                                         "leftmost")[0], want)
    counts = kernels.launch_counts()
    assert counts["find_seam_tiled"] == counts["find_seam"] == 0


def test_tiled_record_and_default_tile():
    assert dp_kernel.TILED_KERNEL in kernels.KERNELS
    assert dp_kernel.TILED_KERNEL.replaces == \
        "dct_carver_tpu/pallas/dp_kernel.py:124,184"
    # the default extended row fits one warp of TILE_C columns a lane, and
    # its halo reaches only the neighbouring tiles
    check_tile_geometry(TILE_W, TILE_K, TILE_C, TILE_WARPS)
    check_tile_geometry(TILE_W, TILE_K, TILE_C, 1, split=True)
    assert TILE_W + 2 * tile_halo(TILE_K) <= 32 * TILE_C
    assert TILE_K <= tile_halo(TILE_K) <= TILE_W


@pytest.mark.parametrize("tile,K", [(6, 4), (0, 4), (48, 0)])
def test_tiled_rejects_bad_tiles(tile, K):
    E = torch.zeros((1, 4, 64))
    with pytest.raises(ValueError):
        _find_seams_tiled(E, 64, 0, "leftmost", tile=tile, K=K)


# the kernel's geometries (tile, K, chunk): extended rows of one warp's
# width (C = 4: 128 columns; C = 8: 256) and one narrower (32 + 2 * 32 of
# 128), on H = 40 rows, so K = 16, 32 and 64 do not divide the 39 DP rows
# (K = 80: one block taller than the plane); (32, 32, 4) and (96, 80, 8)
# have a halo as wide as the owned tile
WARP_GEOMETRIES = [(64, 32, 4), (96, 16, 4), (32, 32, 4), (192, 32, 8),
                   (128, 64, 8), (96, 80, 8)]


# [70, 220) cuts a tile at both ends for every geometry above
@pytest.mark.parametrize("lo,width", [(0, 256), (70, 150)])
@pytest.mark.parametrize("tile,K,chunk", WARP_GEOMETRIES)
@pytest.mark.parametrize("tie", TIES)
def test_warp_tiles_equal_pallas_and_scan(tie, tile, K, chunk, lo, width):
    check_tile_geometry(tile, K, chunk)
    E = _energy("tie-heavy", (40, 256), 21)
    got = _find_seams_tiled(torch.from_numpy(E)[None], width, lo, tie,
                            tile=tile, K=K, chunk=chunk)[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(find_seam_pallas(
        jnp.asarray(E), width, lo, interpret=True, tie=tie)))
    np.testing.assert_array_equal(got, _scan(E, width, lo, tie))


# max_warps caps the kernel's warps: 1, 3 and 7 warps for the 4 x 4 tiles
# give runs of 16, 6 and 3 tiles (several images a run); 0 one tile a warp
@pytest.mark.parametrize("max_warps", [0, 1, 3, 7])
@pytest.mark.parametrize("tie", TIES)
def test_warp_tiles_grouped_per_image_windows(tie, max_warps):
    B, Hb, Wb = 4, 40, 256
    E = _energy("tie-heavy", (B, Hb, Wb), 22)
    width = np.array([Wb, 150, 3, 61], np.int32)
    lo = np.array([0, 70, 253, 64], np.int32)
    got = _find_seams_tiled(torch.from_numpy(E), torch.from_numpy(width),
                            torch.from_numpy(lo), tie, tile=64, K=32,
                            chunk=4, max_warps=max_warps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(find_seams_vec(
        jnp.asarray(E), jnp.asarray(width), jnp.asarray(lo), interpret=True,
        tie=tie)))


@pytest.mark.parametrize("group", [1, 2, 5])
@pytest.mark.parametrize("tie", TIES)
def test_tile_grouping_is_a_no_op(tie, group):
    E = _energy("random", (2, 40, 300), 23)
    want = _tiled(E, 290, 5, tie, 64, 32)
    np.testing.assert_array_equal(tdp.find_seam_tiled(
        torch.from_numpy(E), 290, 5, tie, tile=64, K=32,
        group=group).numpy(), want)
    np.testing.assert_array_equal(want, np.stack(
        [_scan(e, 290, 5, tie) for e in E]))


@pytest.mark.parametrize("tile,K,chunk", [(8, 12, 4), (28, 32, 8),
                                          (32, 33, 8)])
def test_geometry_rejects_a_halo_wider_than_the_tile(tile, K, chunk):
    # each fits the warp's 32 * chunk columns: only the halo rule refuses
    assert tile_halo(K) > tile and tile + 2 * tile_halo(K) <= 32 * chunk
    with pytest.raises(ValueError):
        check_tile_geometry(tile, K, chunk)
    with pytest.raises(ValueError):
        _find_seams_tiled(torch.zeros((1, 4, 64)), 64, 0, "leftmost",
                          tile=tile, K=K, chunk=chunk)


@pytest.mark.parametrize("tile,K,chunk,warps", [(128, 4, 4, 4),
                                                (64, 32, 16, 4),
                                                (64, 32, 4, 0),
                                                (64, 32, 4, 9)])
def test_geometry_rejects_what_no_warp_runs(tile, K, chunk, warps):
    # an extended row wider than a warp, a chunk the kernel lacks, and CTAs
    # of no warp or more than 8
    with pytest.raises(ValueError):
        check_tile_geometry(tile, K, chunk, warps)


# the split schedule: a tile a CTA (its DP warp and two helper warps), at
# every geometry the one-warp schedule takes
@pytest.mark.parametrize("tile,K,chunk", WARP_GEOMETRIES)
def test_geometry_takes_the_split_schedule(tile, K, chunk):
    check_tile_geometry(tile, K, chunk, 1, split=True)


# a split CTA holds one tile; a one-warp CTA up to 8
@pytest.mark.parametrize("warps,split", [(2, True), (8, True), (0, True),
                                         (9, False)])
def test_geometry_rejects_what_no_split_cta_runs(warps, split):
    with pytest.raises(ValueError):
        check_tile_geometry(TILE_W, TILE_K, TILE_C, warps, split)
    with pytest.raises(ValueError):
        _find_seams_tiled(torch.zeros((1, 4, 64)), 64, 0, "leftmost",
                          warps=warps, split=split)


# split_forward: the split schedule up to SPLIT_MAX_TILES tiles of TILE_W
# columns (528: an H100's 132 SMs, four split CTAs each), one warp a tile
# past it (chip_smoke.py's split sweep: 528 tiles split, 529 one warp)
@pytest.mark.parametrize("B,W,tile,split", [
    (1, 1, TILE_W, True), (1, 1920, TILE_W, True), (1, 3840, TILE_W, True),
    (1, 2160, TILE_W, True), (1, 7680, TILE_W, True),
    (8, 1920, TILE_W, True), (16, 1920, TILE_W, True),
    (32, 1024, TILE_W, True), (8, 4096, TILE_W, True),
    (1, SPLIT_MAX_TILES * TILE_W, TILE_W, True),
    (1, SPLIT_MAX_TILES * TILE_W + 1, TILE_W, False),
    (2, SPLIT_MAX_TILES // 2 * TILE_W, TILE_W, True),
    (2, SPLIT_MAX_TILES // 2 * TILE_W + 1, TILE_W, False),
    (1, 40000, TILE_W, False), (16, 4096, TILE_W, False),
    (32, 1920, TILE_W, False), (32, 4096, TILE_W, False),
    (1, 40000, 96, True), (1, 60000, 96, False),
])
def test_split_forward(B, W, tile, split):
    assert SPLIT_MAX_TILES == 528
    assert split_forward(B, W, tile) is split


# the schedule changes no value: the plain algorithm with either holds the
# JAX scan, on a CPU tensor as on the card
@pytest.mark.parametrize("split", [None, False, True])
@pytest.mark.parametrize("tie", TIES)
def test_tiled_schedules_equal_jax_scan(tie, split):
    E = _energy("tie-heavy", (40, 256), 25)
    got = _find_seams_tiled(torch.from_numpy(E)[None], 150, 70, tie,
                            split=split)[0].numpy()
    np.testing.assert_array_equal(got, _scan(E, 150, 70, tie))


# split_forwards: a tiled call counts once where its forward ran (H > 1)
# on the split schedule, beside blocked_finishes; reset_launches clears
# both
def test_split_forwards_counted_once_a_call_and_reset():
    kernels.reset_launches()
    assert TILED_KERNEL.split_forwards == TILED_KERNEL.blocked_finishes == 0
    for h in (2, 1080):
        count_tiled_call(1, h, 1920, True)
    count_tiled_call(1, 1080, 1920, False)  # one warp a tile
    count_tiled_call(1, 1, 1920, True)  # no forward at H = 1
    count_tiled_call(32, 1080, 1920, False)
    assert TILED_KERNEL.split_forwards == 2
    assert TILED_KERNEL.blocked_finishes == 2  # the two 1080 x 1920 planes
    kernels.reset_launches()
    assert TILED_KERNEL.split_forwards == TILED_KERNEL.blocked_finishes == 0


def test_split_forwards_credited_by_graph_replays(monkeypatch):
    """The seam step's graphs credit `split_forwards` on every replay, as
    they credit the launches and `blocked_finishes`."""
    from dct_carver_tpu_torch.ops import carve as tcarve
    from dct_carver_tpu_torch.utils import graphs as tgraphs

    seen = []

    class Recorder:
        def __init__(self, devices, what, counters):
            seen.extend(counters)

    monkeypatch.setattr(tcarve, "graphed", lambda dev, p: True)
    monkeypatch.setattr(tgraphs, "StepGraphs", Recorder)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: None)
    state = tcarve.make_state(torch.zeros((8, 16)))
    p = tcarve.StepParams(8, 0.0, 1.0, True, True, 1, 0.0, "leftmost", None)
    tcarve.SeamSteps(state, p)
    assert (TILED_KERNEL, "split_forwards") in seen
    assert (TILED_KERNEL, "blocked_finishes") in seen


# seam_route: rows wider than one thread block always take the tiled
# kernel; below, one image of 64 columns or more and stacks of up to 32
# images do (chip_smoke.py's width sweep), the rest find_seam.cu
@pytest.mark.parametrize("B,W,want", [
    (1, 1, "find_seam"), (1, 63, "find_seam"), (1, 64, "tiled"),
    (1, 1920, "tiled"), (1, 7680, "tiled"), (1, MAX_WIDTH - 1, "tiled"),
    (1, MAX_WIDTH, "tiled"), (1, MAX_WIDTH + 1, "tiled"),
    (1, 40000, "tiled"), (8, 1024, "tiled"), (32, 1024, "tiled"),
    (32, 4096, "tiled"), (33, 1024, "find_seam"), (64, 1024, "find_seam"),
    (64, 1920, "find_seam"), (256, 1024, "find_seam"),
    (256, MAX_WIDTH, "find_seam"), (256, MAX_WIDTH + 1, "tiled"),
    (32, 63, "find_seam"),
])
def test_seam_route(B, W, want):
    assert seam_route(B, W) == want


# planes past the finish's FINISH_ROWS rows a block: one block and a row
# more, two blocks and a row, and several with a ragged last block
@pytest.mark.parametrize("h", [FINISH_ROWS + 1, 2 * FINISH_ROWS + 1, 300])
@pytest.mark.parametrize("tie", TIES)
def test_tiled_blocked_finish_equals_jax_scan(tie, h):
    E = _energy("tie-heavy", (h, 200), 24)
    got = _tiled(E, 190, 5, tie, 48, 8)
    np.testing.assert_array_equal(got, _scan(E, 190, 5, tie))


# the kernel's scratch: the frontier's ceil((H - 1) / K) slices of B x W
# cells, a cell an image and the tickets' cell, rounded up to an even count
# of cells, then the jumps, B x blocks rows of W rounded up to 16 bytes, at
# two blocks or more
@pytest.mark.parametrize("B,H,W,K,want", [
    (1, 1, 64, 32, 1),
    (1, 65, 64, 32, 2 * 64 + 1 + 1),
    (1, 66, 64, 32, 3 * 64 + 1 + 1 + 2 * 64 // 8),
    (2, 200, 100, 32, 7 * 2 * 100 + 2 + 1 + 1 + 2 * 4 * 112 // 8),
    (1, 1080, 1920, 32, 34 * 1920 + 1 + 1 + 17 * 1920 // 8),
])
def test_tiled_scratch_cells(B, H, W, K, want):
    assert dp_kernel.tiled_scratch_cells(B, H, W, K) == want


# the finish composes more than one block of rows where B * W columns pay
# for it (FINISH_COMPOSE_COLUMNS), and walks the rows block after block
# elsewhere: the counts `blocked_finishes` adds a call
@pytest.mark.parametrize("B,H,W,want", [
    (1, 1, 64, False), (1, 65, 1920, False), (1, 66, 1920, True),
    (1, 1080, 1920, True), (16, 1080, 1920, True), (32, 1080, 1024, True),
    (32, 1080, 1920, False), (1, 512, 40000, True), (2, 1080, 40000, False),
])
def test_finish_composes_blocks(B, H, W, want):
    assert dp_kernel.composes_blocks(B, H, W) is want
