"""The spatial route's kernels, through their plain versions, against the
JAX package's (`dct_carver_tpu/pallas/spatial_dp_kernel.py`), and the strip
with a shard offset against the unsharded strip.

Every input comes from a seed through numpy; these paths only add, compare
and copy, so every comparison is bitwise.  On the CPU each wrapper takes
its plain version (no kernel is built here); `chip_smoke.py` holds the CUDA
kernels against the same plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_carver_tpu.pallas import spatial_dp_kernel as jsp
from dct_carver_tpu_torch import kernels
from dct_carver_tpu_torch.kernels.spatial_kernel import (
    BLOCK_KERNEL, PARTS_KERNEL, TILE_SPAN, block_dp, block_dp_parts,
    scan_rows, seg_walk, sharded_apply, tile_bounds, tile_plan, walk_rows)
from dct_carver_tpu_torch.kernels.strip_kernel import (
    strip_gather, strip_scatter, strip_update)
from dct_carver_tpu_torch.ops.strip import ShardOffset, _strip_extent


def _energy(rng, shape, quantized=False):
    if quantized:  # many ties
        return (rng.integers(0, 3, shape) / 2).astype(np.float32)
    return rng.random(shape, dtype=np.float32)


@pytest.mark.parametrize("Kb,width,quantized", [
    (8, 70, False),   # full block, the width ends inside shard 2's window
    (5, 64, True),    # a remainder block (rem < K), ties
])
def test_block_dp_equals_jax(Kb, width, quantized):
    S, Wl, Hh = 4, 16, 16
    We = Wl + 2 * Hh
    rng = np.random.default_rng(Kb)
    msg = _energy(rng, (S, Kb + 1, We), quantized)
    kernels.reset_launches()
    got = block_dp(torch.from_numpy(msg), 0, torch.tensor([width],
                   dtype=torch.int32), Hh).numpy()
    assert sum(kernels.launch_counts().values()) == 0
    for s in range(S):
        col0 = s * Wl - Hh  # negative on shard 0
        want = jsp._plain_block_dp(jnp.asarray(msg[s]), col0, width, Kb)
        np.testing.assert_array_equal(got[s], np.asarray(want))


def test_block_dp_parts_equals_jax_and_block_dp():
    S, Kb, Wl, Hh, lo, width = 3, 6, 24, 12, 24, 90
    rng = np.random.default_rng(3)
    prev = _energy(rng, (S, Wl))
    E = _energy(rng, (S, Kb, Wl))
    lh, rh = _energy(rng, (S, Kb + 1, Hh)), _energy(rng, (S, Kb + 1, Hh))
    w = torch.tensor([width], dtype=torch.int32)
    out = torch.full((S, Kb, Wl + 2 * Hh), -1.0)
    got = block_dp_parts(*map(torch.from_numpy, (prev, E, lh, rh)), lo, w,
                         out=out)
    assert got is out
    msg = np.concatenate([lh, np.concatenate([prev[:, None], E], 1), rh], 2)
    np.testing.assert_array_equal(
        got.numpy(), block_dp(torch.from_numpy(msg), lo, w, Hh).numpy())
    for s in range(S):
        want = jsp.block_dp_parts_rows(
            jnp.asarray(prev[s]), jnp.asarray(E[s]), jnp.asarray(lh[s]),
            jnp.asarray(rh[s]), lo + s * Wl - Hh, width, interpret=True)
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want))


# ---------------------------------------------- the block DP's column tiles --

def _check_tiles(Kb, We):
    """tile_plan(Kb, We)'s T tiles cover [0, We) once, each with at least
    min(Kb, what the row holds) ghost columns a side, in one warp's
    TILE_SPAN columns; returns the plan and (a, b, x0, x1) a tile."""
    plan = T, Wt, Hg = tile_plan(Kb, We)
    assert T > 0 and Hg >= Kb and Hg % 4 == 0
    bounds = tile_bounds(We, plan)
    assert len(bounds) == T
    assert bounds[0][0] == 0 and bounds[-1][1] == We
    assert all(b0 == a1 for (_, b0), (a1, _) in zip(bounds, bounds[1:]))
    tiles = []
    for a, b in bounds:
        assert a < b and (len(bounds) == 1 or a % 4 == 0)
        x0, x1 = max(a - Hg, 0), min(b + Hg, We)
        assert a - x0 >= min(Kb, a) and x1 - b >= min(Kb, We - b)
        assert x1 - x0 <= TILE_SPAN
        tiles.append((a, b, x0, x1))
    return plan, tiles


@pytest.mark.parametrize("S,Wl,Hh,Kb,widths", [
    (4, 1920, 192, 96, (7680, 6980, 1950, 3890)),  # the 8K shard shape
    (4, 1920, 192, 95, (7680,)),      # the last block of a 4320-row seam
    (4, 1920, 192, 17, (3890,)),      # short blocks: wider tiles
    (4, 1920, 192, 3, (1950, 7680)),
    (4, 1900, 192, 96, (7600, 1930)),  # We = 2284: no multiple of the tile
    (2, 1920, 192, 60, (3840, 1950)),  # 136 owned columns a tile
    (1, 1920, 192, 1, (1920,)),       # 248 owned columns a tile
    (8, 32, 192, 96, (256, 211, 101)),  # the message form's small shards
    (8, 32, 192, 64, (256, 211)),
    (8, 32, 64, 32, (256, 211)),
    (4, 48, 192, 96, (192, 187)),     # halos wider than the owned columns
    (3, 50, 192, 41, (150, 145)),     # rows no multiple of 4
    (2, 7, 64, 32, (14, 9)),          # a row of one tile
])
def test_tiles_rebuild_the_block_bitwise(S, Wl, Hh, Kb, widths):
    """The exactness the tiled block DP (csrc/spatial_dp.cu) rests on: each
    tile of `tile_plan`, scanned alone on its span (its owned columns and
    ghost zones, clamped to the extended row, +inf beyond) by the plain
    `scan_rows`, gives owned columns bitwise equal to `scan_rows` over the
    whole extended row, dead columns past the width included.  The
    frontier is scaled far above a block's energy, so that a cell's value
    often comes from the far end of its cone: ghost zones 4 columns short
    of Kb make the 8K and small-shard cases differ."""
    We = Wl + 2 * Hh
    plan, tiles = _check_tiles(Kb, We)
    rng = np.random.default_rng(S * 1000 + Wl + Kb)
    msg = torch.from_numpy(_energy(rng, (S, Kb + 1, We)))
    msg[:, 0] *= 1e6
    col0 = Wl * torch.arange(S) - Hh
    for width in widths:
        w = torch.tensor([width], dtype=torch.int32)
        whole = scan_rows(msg, col0, w)
        got = torch.full_like(whole, float("nan"))
        for a, b, x0, x1 in tiles:
            part = scan_rows(msg[:, :, x0:x1].contiguous(), col0 + x0, w)
            got[:, :, a:b] = part[:, :, a - x0:b - x0]
        np.testing.assert_array_equal(got.numpy(), whole.numpy(),
                                      err_msg=f"plan {plan} width {width}")


@pytest.mark.parametrize("Kb,We,plan", [
    (96, 2304, (33, 64, 96)),         # the 8K shard shape: 132 CTAs
    (95, 2304, (33, 64, 96)),
    (3, 2304, (10, 248, 4)),
    (96, 416, (4, 64, 96)),           # 8 shards of 32 columns, K = 96
    (32, 160, (1, 160, 32)),          # a row one warp holds
    (60, 2284, (16, 136, 60)),        # We no multiple of the tile
    (96, 257, (2, 64, 96)),           # one column past the warp
    (200, 256, (1, 256, 200)),        # a tall block on a narrow row
    (1, 40000, (162, 248, 4)),
])
def test_tile_plan(Kb, We, plan):
    """A warp of TILE_SPAN columns holds the whole row, or 64 owned
    columns or more and Kb ghost columns a side; T tiles cover the row
    once."""
    got, tiles = _check_tiles(Kb, We)
    assert got == plan and len(tiles) == plan[0]


def test_tile_plan_falls_back_to_one_cta_a_shard():
    """No warp holds 64 owned columns and more than 96 ghost columns a
    side: a row wider than TILE_SPAN columns takes one CTA a shard, whose
    one tile owns the whole row."""
    for Kb, We in ((97, 2304), (200, 257), (1000, 1025), (4320, 32768)):
        assert tile_plan(Kb, We) == (0, We, 0)
        assert tile_bounds(We, tile_plan(Kb, We)) == [(0, We)]
    assert tile_plan(96, 2304)[0] == 33


def test_tiled_blocks_is_a_counter_reset_with_the_launches():
    """`tiled_blocks` sits in COUNTERS (so graph replays credit it) on both
    block-DP records, and reset_launches clears it; the plain path counts
    nothing."""
    assert (BLOCK_KERNEL, "tiled_blocks") in kernels.COUNTERS
    assert (PARTS_KERNEL, "tiled_blocks") in kernels.COUNTERS
    BLOCK_KERNEL.tiled_blocks = PARTS_KERNEL.tiled_blocks = 7
    kernels.reset_launches()
    assert BLOCK_KERNEL.tiled_blocks == PARTS_KERNEL.tiled_blocks == 0
    rng = np.random.default_rng(1)
    msg = torch.from_numpy(_energy(rng, (4, 9, 48)))
    block_dp(msg, 0, torch.tensor([64], dtype=torch.int32), 16)
    assert BLOCK_KERNEL.tiled_blocks == PARTS_KERNEL.tiled_blocks == 0
    assert "tiled_blocks" not in kernels.launch_counts()


def test_spatial_steps_credit_tiled_blocks(monkeypatch):
    """The spatial route's seam step hands its graphs every counter of
    COUNTERS, `tiled_blocks` among them, so that replays credit it."""
    from dct_carver_tpu_torch.parallel import spatial as tspatial
    from dct_carver_tpu_torch.utils import graphs as tgraphs

    seen = []

    class Recorder:
        def __init__(self, devices, what, counters):
            seen.extend(counters)

    monkeypatch.setattr(tgraphs, "StepGraphs", Recorder)
    st, mesh = tspatial.spatial_make_state(torch.zeros((8, 32)),
                                           devices=["cpu"] * 2)
    tspatial._SeamSteps(mesh, st, tspatial._params(32, 8))
    assert (PARTS_KERNEL, "tiled_blocks") in seen
    assert (BLOCK_KERNEL, "tiled_blocks") in seen


def test_scan_rows_generalized_dp_equals_jax_scan():
    """delta_x = 2 with a rigidity penalty: the plain route's DP equals the
    JAX package's masked scan (ops/dp.py's candidate order)."""
    from dct_carver_tpu.ops.dp import cumulative_energy

    rng = np.random.default_rng(5)
    E = _energy(rng, (9, 20))
    msg = np.concatenate([np.zeros((1, 20), np.float32), E])
    got = scan_rows(torch.from_numpy(msg)[None], torch.tensor([0]), 20,
                    delta_x=2, rigidity=0.5)[0].numpy()
    want = np.asarray(cumulative_energy(jnp.asarray(E), delta_x=2,
                                        rigidity=0.5))
    # row 0 of M is e0 + min(0, 0, ...) = e0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
@pytest.mark.parametrize("entry,Kb", [
    (21, 8),   # inside shard 1
    (16, 8),   # shard 1's first column: the window touches shard 0's halo
    (47, 5),   # the last column of the last shard, a short segment
    (0, 8),    # column 0: the window starts at the extended row's edge
])
def test_seg_walk_equals_jax(tie, entry, Kb):
    S, Wl, K = 3, 16, 8
    Hh = 2 * K
    We = Wl + 2 * Hh
    rng = np.random.default_rng(entry + Kb)
    rows = _energy(rng, (S, Kb, We), quantized=True)
    got = seg_walk(torch.from_numpy(rows),
                   torch.tensor([entry], dtype=torch.int32), 0, K, Hh,
                   tie=tie).numpy()
    owner = entry // Wl
    start = entry - owner * Wl + Hh - K
    win = jnp.asarray(rows[owner, :, start:start + 2 * K + 1])
    want = np.asarray(jsp.seg_walk_rows(win, K, interpret=True, tie=tie))
    np.testing.assert_array_equal(got[owner], want + entry - K)
    others = np.delete(got, owner, axis=0)
    assert not others.any()


# ------------------------------------------- the staged walk's algorithm --

_WALK_ROWS, _WALK_DEPTH, _SMEM = 16, 8, 232448


def _parent(left, centre, right, tie):
    """csrc/spatial_dp.cu::parent: -1/0/+1, the tie-most minimum."""
    if tie == "leftmost":
        if left <= centre:
            return -1 if left <= right else 1
        return 0 if centre <= right else 1
    if right <= centre:
        return 1 if right <= left else -1
    return 0 if centre <= left else -1


def _staged_walk(rows, entry, lo, K, Hh, tie, depth=None):
    """The algorithm of `csrc/spatial_dp.cu::seg_walk_kernel` in numpy:
    the owner aligns its window start down to 4 columns, stages the window's
    f32 rows in _WALK_ROWS-row chunks from the bottom up into a ring of
    `depth` slots (a slot is staged again only after its chunk was walked),
    and walks each chunk on the f32 values with parent()'s rule, +inf
    outside the window.  Unstaged ring cells are NaN, so a read of one shows
    as a wrong seam."""
    S, Kb, We = rows.shape
    Wl = We - 2 * Hh
    ww = 2 * K + 1
    pitch = (ww + 6) // 4 * 4
    nchunks = max(-(-Kb // _WALK_ROWS), 1)
    if depth is None:
        depth = min(nchunks, _WALK_DEPTH, _SMEM // (_WALK_ROWS * pitch * 4))
    seg = np.zeros((S, Kb), np.int32)
    for s in range(S):
        lo_s = lo + s * Wl
        if not lo_s <= entry < lo_s + Wl:
            continue
        wstart = min(max(entry - lo_s + Hh - K, 0), We - ww)
        a0 = wstart & ~3
        ncols = (wstart + ww - a0 + 3) & ~3
        assert wstart - a0 < 4 and ncols <= pitch
        ring = np.full((depth, _WALK_ROWS, pitch), np.nan, np.float32)

        def bounds(c):
            r1 = Kb - c * _WALK_ROWS
            return max(r1 - _WALK_ROWS, 0), r1

        def stage(c):
            r0, r1 = bounds(c)
            slot = ring[c % depth]
            slot[:] = np.nan
            n = min(ncols, We - a0)
            for r in range(r1 - 1, r0 - 1, -1):
                slot[r1 - 1 - r, :n] = rows[s, r, a0:a0 + n]

        for c in range(min(depth, nchunks)):
            stage(c)
        jl = K
        for c in range(nchunks):
            r0, r1 = bounds(c)
            win = ring[c % depth][:, wstart - a0:]
            for r in range(r1 - 1, r0 - 1, -1):
                row = win[r1 - 1 - r]
                w = min(max(jl, 0), ww - 1)
                left = row[w - 1] if w > 0 else np.inf
                right = row[w + 1] if w < ww - 1 else np.inf
                jl += _parent(left, row[w], right, tie)
                seg[s, r] = jl + entry - K
            if c + depth < nchunks:
                stage(c + depth)
    return seg


@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
@pytest.mark.parametrize("K,Hh,Kb,entry", [
    (8, 16, 8, 21),     # inside shard 1, one chunk
    (24, 4, 24, 64),    # the window clamped at column 0
    (24, 4, 24, 127),   # the window clamped at We - ww
    (24, 48, 24, 64),   # window starts 24 .. 27: every residue mod 4
    (24, 48, 24, 65),
    (24, 48, 24, 66),
    (24, 48, 24, 67),
    (40, 80, 37, 100),  # Kb < K, three chunks, the last one short
    (40, 80, 5, 191),   # a short segment, the last column of the last shard
])
def test_staged_walk_equals_jax(tie, K, Hh, Kb, entry):
    """The staged walk (aligned window, chunked bottom-up staging, the walk
    on f32 values) equals JAX's one-hot walk in interpret mode, the plain
    walk and `seg_walk`; every other shard gets zeros."""
    S, Wl = 3, 64
    We = Wl + 2 * Hh
    rng = np.random.default_rng(K * 1000 + entry + Kb)
    rows = _energy(rng, (S, Kb, We), quantized=True)
    got = _staged_walk(rows, entry, 0, K, Hh, tie)
    owner = entry // Wl
    start = min(max(entry - owner * Wl + Hh - K, 0), We - (2 * K + 1))
    win = jnp.asarray(rows[owner, :, start:start + 2 * K + 1])
    want = np.asarray(jsp.seg_walk_rows(win, K, interpret=True, tie=tie))
    np.testing.assert_array_equal(got[owner], want + entry - K)
    assert not np.delete(got, owner, axis=0).any()
    t, e = torch.from_numpy(rows), torch.tensor([entry], dtype=torch.int32)
    np.testing.assert_array_equal(
        got, walk_rows(t, e, 0, K, Hh, tie).numpy())
    np.testing.assert_array_equal(
        got, seg_walk(t, e, 0, K, Hh, tie=tie).numpy())
    for depth in (1, 2):  # rings that a slot must be staged again in
        np.testing.assert_array_equal(
            got, _staged_walk(rows, entry, 0, K, Hh, tie, depth=depth))


@pytest.fixture(scope="module")
def jax_walk():
    """JAX's scalar-scan segment walk (`parallel/spatial.py::_seg_walk`,
    the form for windows wider than 256 lanes) on the 8-device CPU mesh:
    (rows (8, Kb, We), entry, K, tie) -> (Kb,) global columns."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from dct_carver_tpu.parallel import spatial as jspatial
    from dct_carver_tpu.parallel.mesh import make_mesh as jax_mesh

    mesh = jax_mesh(axis_name="x")
    fns = {}

    def walk(rows, entry, K, tie):
        S, Kb, We = rows.shape
        Hh = 2 * K
        key = (Kb, We, K, tie)
        if key not in fns:
            fns[key] = jax.jit(shard_map(
                lambda r, j: jspatial._seg_walk(r[0], j[0], We - 2 * Hh, K,
                                                "x", tie=tie),
                mesh=mesh, in_specs=(P("x"), P()), out_specs=P(),
                check_vma=False))
        return np.asarray(fns[key](jnp.asarray(rows),
                                   jnp.asarray([entry], jnp.int32)))

    return walk


@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
@pytest.mark.parametrize("Kb,entry", [(200, 37), (150, 127)])
def test_staged_walk_at_k200_equals_jax_scan(jax_walk, tie, Kb, entry):
    """K = 200: a 401-column window in 13 chunks through a ring of 8 slots
    (the most one block's shared memory holds at this K), against the plain
    walk and JAX's scalar scan."""
    S, Wl, K = 8, 16, 200
    Hh = 2 * K
    rng = np.random.default_rng(Kb + entry)
    rows = _energy(rng, (S, Kb, Wl + 2 * Hh), quantized=True)
    got = _staged_walk(rows, entry, 0, K, Hh, tie)
    want = jax_walk(rows, entry, K, tie)
    owner = entry // Wl
    np.testing.assert_array_equal(got[owner], want)
    assert not np.delete(got, owner, axis=0).any()
    t, e = torch.from_numpy(rows), torch.tensor([entry], dtype=torch.int32)
    np.testing.assert_array_equal(got, walk_rows(t, e, 0, K, Hh, tie).numpy())
    np.testing.assert_array_equal(got,
                                  seg_walk(t, e, 0, K, Hh, tie=tie).numpy())


def test_walk_rows_generalized_equals_scalar_walk():
    """delta_x = 2 with rigidity: the plain walk of the route's generalized
    DP equals ops/dp.py's backtrack on the same window."""
    from dct_carver_tpu_torch.ops.dp import backtrack

    S, Wl, K, d = 2, 20, 4, 2
    Hh = 2 * K * d
    We = Wl + 2 * Hh
    rng = np.random.default_rng(9)
    rows = torch.from_numpy(_energy(rng, (S, K, We), quantized=True))
    entry = 27
    got = walk_rows(rows, torch.tensor([entry], dtype=torch.int32), 0, K,
                    Hh, "rightmost", delta_x=d, rigidity=0.7)
    win = rows[1, :, entry - Wl + Hh - K * d:][:, :2 * K * d + 1]
    # the walk from the window's centre below the last row: append a row
    # whose only finite cell is that centre, then backtrack
    below = torch.full((1, win.shape[1]), float("inf"))
    below[0, K * d] = 0.0
    want = backtrack(torch.cat([win, below]), d, 0.7, "rightmost")[:-1]
    np.testing.assert_array_equal(got[1].numpy(),
                                  want.numpy() + entry - K * d)
    assert not got[0].any()


@pytest.mark.parametrize("new_width", [63, 61])
def test_sharded_apply_equals_jax(new_width):
    S, H, Wl = 4, 8, 16
    rng = np.random.default_rng(new_width)
    luma = _energy(rng, (S, H, Wl))
    E = _energy(rng, (S, H, Wl))
    oc = rng.integers(0, 1000, (S, H, Wl)).astype(np.int32)
    # the seam crosses every shard boundary, and sits on one
    seam = np.array([0, 15, 16, 31, 32, 47, 48, new_width], np.int32)
    edge = _energy(rng, (H,))
    inc = np.concatenate([luma[:, :, :1], E[:, :, :1],
                          oc[:, :, :1].view(np.float32)], axis=2)
    inc = np.concatenate([inc[1:], np.zeros_like(inc[:1])])  # from the right
    nw = torch.tensor([new_width], dtype=torch.int32)
    got = sharded_apply(*map(torch.from_numpy, (luma, oc, E, seam, edge,
                                                inc)), nw, 0)
    assert [g.dtype for g in got] == [torch.float32, torch.int32,
                                      torch.float32, torch.int32]
    for s in range(S):
        want = jsp._plain_sharded_apply(
            jnp.asarray(luma[s]), jnp.asarray(oc[s]), jnp.asarray(E[s]),
            jnp.asarray(seam), jnp.asarray(edge), jnp.asarray(inc[s]),
            new_width, s * Wl)
        for g, w in zip(got, (want[0], want[1], want[2], want[3][:, 0])):
            np.testing.assert_array_equal(g[s].numpy(), np.asarray(w))


def _shards(x, S, n):
    """(H, W) -> (S, H, Wl) owned columns and (S, H, Wl + n - 1) luma with
    the edge-clamped r-1 / r halo."""
    H, W = x.shape
    Wl, r = W // S, n // 2
    cols = np.clip(np.arange(-(r - 1), W + r), 0, W - 1)
    ext = x[:, cols]
    owned = x.reshape(H, S, Wl).transpose(1, 0, 2)
    halo = np.stack([ext[:, s * Wl:s * Wl + Wl + n - 1] for s in range(S)])
    return np.ascontiguousarray(owned), np.ascontiguousarray(halo)


@pytest.mark.parametrize("n", [2, 8, 16])
def test_offset_strip_equals_unsharded_strip(n):
    H, W, S = 20, 96, 4
    rng = np.random.default_rng(n)
    luma = rng.random((H, W), dtype=np.float32)
    energy = rng.random((H, W), dtype=np.float32)
    # a seam that wanders over every shard and both image edges
    seam = np.clip(np.cumsum(rng.integers(-1, 2, H)) + W // 2, 0,
                   W - 1).astype(np.int32)
    seam[:4] = [0, 1, W - 2, W - 1]
    t = torch.from_numpy
    shard = ShardOffset(0, W)
    want = strip_update(t(luma), t(energy).clone(), t(seam), n, 0.3, 0.7)
    owned_e, _ = _shards(energy, S, n)
    _, halo = _shards(luma, S, n)
    got = strip_update(t(halo), t(owned_e).clone(), t(seam), n, 0.3, 0.7,
                       shard=shard)
    np.testing.assert_array_equal(
        got.permute(1, 0, 2).reshape(H, W).numpy(), want.numpy())

    # the gather: every band column a shard's scatter keeps equals the
    # unsharded band's; the scatter keeps exactly the owned columns
    bands = strip_gather(t(luma), t(seam), n)
    sb = strip_gather(t(halo), t(seam), n, shard=shard)
    strip_w = _strip_extent(n)[1]
    start = np.clip(seam.astype(np.int64) - _strip_extent(n)[0], 0,
                    W - strip_w)
    for s in range(S):
        for i in range(H):
            for c in range(strip_w):
                if s * (W // S) <= start[i] + c < (s + 1) * (W // S):
                    np.testing.assert_array_equal(
                        sb[s, i, :, c:c + n].numpy(),
                        bands[i, :, c:c + n].numpy())
    strip = t(rng.random((H, strip_w), dtype=np.float32))
    want = strip_scatter(t(energy).clone(), strip, t(seam), n)
    got = strip_scatter(t(owned_e).clone(),
                        strip[None].expand(S, H, strip_w).contiguous(),
                        t(seam), n, shard=shard)
    np.testing.assert_array_equal(
        got.permute(1, 0, 2).reshape(H, W).numpy(), want.numpy())

