"""The tiled find-seam (plain PyTorch, CPU) against the JAX package.

`csrc/find_seam_tiled.cu` cuts rows wider than one thread block over
column tiles with halos and runs K DP rows a launch from a ping-pong
frontier.  `ops/dp.py::find_seam_tiled` is that algorithm in plain
PyTorch; it must give the seams of the JAX scan DP and of the Pallas
kernels (interpret mode), bit for bit, with small tiles, on ragged last
tiles, in column windows, along tile edges and borders, and per image of
a stack.
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
from dct_carver_tpu_torch.kernels.dp_kernel import (MAX_WIDTH, TILE_K,
                                                    TILE_W, _find_seams_tiled,
                                                    find_seam, find_seams)
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
    # the default extended row stays at 4 columns a thread (<= 4096)
    assert TILE_W % 4 == 0 and TILE_W + 2 * TILE_K == 4096


@pytest.mark.parametrize("tile,K", [(6, 4), (0, 4), (48, 0)])
def test_tiled_rejects_bad_tiles(tile, K):
    E = torch.zeros((1, 4, 64))
    with pytest.raises(ValueError):
        _find_seams_tiled(E, 64, 0, "leftmost", tile=tile, K=K)
