"""The port's find-seam (plain PyTorch, CPU) against the JAX package.

The port's `find_seam` must give the very seams of the Pallas kernel
(interpret mode) and of the JAX scan DP, bit for bit: the DP only adds and
compares, so no rounding can differ.  Quantized energies force exact ties
through both tie rules.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_carver_tpu.oracle import reference as oracle
from dct_carver_tpu.ops import dp as jdp
from dct_carver_tpu.pallas.batch_dp_kernel import find_seams_vec
from dct_carver_tpu.pallas.dp_kernel import find_seam_pallas
from dct_carver_tpu_torch import kernels
from dct_carver_tpu_torch.kernels.dp_kernel import FINISH_ROWS, find_seam
from dct_carver_tpu_torch.ops import dp as tdp

H, W = 24, 128  # the Pallas kernel wants H % 8 == 0 and W % 128 == 0


def _energy(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random((H, W), dtype=np.float32)
    return (rng.integers(0, 4, (H, W)) / 4).astype(np.float32)


@pytest.mark.parametrize("width", [W, W - 37])
@pytest.mark.parametrize("kind", ["random", "quantized"])
@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
def test_find_seam_equals_pallas_and_scan(tie, kind, width):
    E = _energy(kind, 3 if kind == "random" else 4)
    want_pallas = np.asarray(find_seam_pallas(jnp.asarray(E), width,
                                              interpret=True, tie=tie))
    want_scan = np.asarray(jdp.find_seam(
        jdp.mask_energy(jnp.asarray(E), width), tie=tie))
    kernels.reset_launches()
    got = find_seam(torch.from_numpy(E), width, tie=tie)
    assert got.dtype == torch.int32 and got.shape == (H,)
    np.testing.assert_array_equal(got.numpy(), want_pallas)
    np.testing.assert_array_equal(got.numpy(), want_scan)
    assert int(got.max()) < width
    assert kernels.launch_counts()["find_seam"] == 0


@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
def test_rigidity_dp_equals_jax_and_oracle(tie):
    E = (np.random.default_rng(9).integers(0, 5, (30, 41)) / 4).astype(
        np.float32)
    want = np.asarray(jdp.find_seam(jnp.asarray(E), 2, 0.5, tie))
    got = tdp.find_seam(torch.from_numpy(E), 2, 0.5, tie).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle.find_seam(E, 2, 0.5, tie))
    assert np.abs(np.diff(got)).max() <= 2


def test_cumulative_energy_equals_oracle():
    E = np.random.default_rng(1).random((37, 53), dtype=np.float32)
    np.testing.assert_array_equal(
        tdp.cumulative_energy(torch.from_numpy(E)).numpy(),
        oracle.cumulative_energy(E))


def test_remove_seam_and_mask_equal_jax():
    rng = np.random.default_rng(2)
    arr = rng.random((20, 30, 3), dtype=np.float32)
    seam = rng.integers(0, 30, 20).astype(np.int32)
    np.testing.assert_array_equal(
        tdp.remove_seam(torch.from_numpy(arr), torch.from_numpy(seam)).numpy(),
        np.asarray(jdp.remove_seam(jnp.asarray(arr), jnp.asarray(seam))))
    E = arr[..., 0]
    np.testing.assert_array_equal(
        tdp.mask_energy(torch.from_numpy(E), 17).numpy(),
        np.asarray(jdp.mask_energy(jnp.asarray(E), 17)))


def test_find_seam_rejects_bad_arguments():
    E = torch.from_numpy(_energy("random", 0))
    with pytest.raises(ValueError):
        find_seam(E, W, tie="middle")
    with pytest.raises(ValueError):
        find_seam(E, W + 1)
    with pytest.raises(ValueError):
        find_seam(E, 0)


# ---------------------------------------------- the kernel's backtrack --
# `csrc/find_seam.cu` writes int8 parent directions in the forward and
# walks them up in windows of K rows.  `ops/dp.py::parent_directions` and
# `backtrack_windowed` are that algorithm in plain PyTorch; it must give
# the seams of the JAX scan DP and of the Pallas kernel (interpret mode).


def _windowed(E, K, tie):
    """The kernel's algorithm on an already masked energy."""
    M = tdp.cumulative_energy(torch.from_numpy(np.array(E)))
    return tdp.backtrack_windowed(tdp.parent_directions(M, tie), M[..., -1, :],
                                  K, tie).numpy()


def _tie_heavy(shape, seed):
    """Quantized to {0, 1/2}: most cells tie with a neighbour."""
    return (np.random.default_rng(seed).integers(0, 2, shape) / 2).astype(
        np.float32)


@pytest.mark.parametrize("K", [64, 5])
@pytest.mark.parametrize("width", [W, W - 37])
@pytest.mark.parametrize("kind", ["random", "quantized"])
@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
def test_windowed_backtrack_equals_pallas_and_scan(tie, kind, width, K):
    # K = 64: a plane narrower than one window (W = 128 < 2K + 1)
    E = _energy(kind, 3 if kind == "random" else 4)
    masked = np.asarray(jdp.mask_energy(jnp.asarray(E), width))
    got = _windowed(masked, K, tie)
    np.testing.assert_array_equal(got, np.asarray(find_seam_pallas(
        jnp.asarray(E), width, interpret=True, tie=tie)))
    np.testing.assert_array_equal(
        got, np.asarray(jdp.find_seam(jnp.asarray(masked), tie=tie)))
    assert got.dtype == np.int32 and got.shape == (H,)


@pytest.mark.parametrize("lo,width", [(37, 80), (120, 8)])
@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
def test_windowed_backtrack_in_a_lo_window(tie, lo, width):
    E = _tie_heavy((H, W), 5)
    masked = tdp.mask_energy(torch.from_numpy(E), width, lo).numpy()
    got = _windowed(masked, 6, tie)
    np.testing.assert_array_equal(got, np.asarray(find_seam_pallas(
        jnp.asarray(E), width, lo, interpret=True, tie=tie)))
    assert (got >= lo).all() and (got < lo + width).all()


@pytest.mark.parametrize("w", [1, 9, 10, 11, 12])
@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
def test_windowed_backtrack_at_window_widths(tie, w):
    # K = 5: W < 2K + 1 (1, 9, 10), W = 2K + 1 (11) and W > 2K + 1 (12),
    # 23 rows (no multiple of K)
    E = _tie_heavy((23, w), 6)
    np.testing.assert_array_equal(
        _windowed(E, 5, tie), np.asarray(jdp.find_seam(jnp.asarray(E),
                                                       tie=tie)))


@pytest.mark.parametrize("K", [64, 4])
@pytest.mark.parametrize("border", ["first", "last"])
@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
def test_windowed_backtrack_along_a_border(tie, border, K):
    E = np.ones((H, W), np.float32)
    col = 0 if border == "first" else W - 1
    E[:, col] = 0
    got = _windowed(E, K, tie)
    assert (got == col).all()
    np.testing.assert_array_equal(got, np.asarray(find_seam_pallas(
        jnp.asarray(E), W, interpret=True, tie=tie)))


@pytest.mark.parametrize("kind", ["random", "tie-heavy"])
@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
def test_windowed_backtrack_of_a_stack_with_per_image_windows(tie, kind):
    B, Hb, Wb = 4, 24, 256
    E = (np.random.default_rng(7).random((B, Hb, Wb), dtype=np.float32)
         if kind == "random" else _tie_heavy((B, Hb, Wb), 8))
    width = np.array([Wb, 200, 3, 17], np.int32)
    lo = np.array([0, 37, 253, 0], np.int32)
    masked = tdp.mask_energy(torch.from_numpy(E), torch.from_numpy(width),
                             torch.from_numpy(lo)).numpy()
    got = _windowed(masked, 8, tie)
    np.testing.assert_array_equal(got, np.asarray(find_seams_vec(
        jnp.asarray(E), jnp.asarray(width), jnp.asarray(lo), interpret=True,
        tie=tie)))
    np.testing.assert_array_equal(got, tdp.find_seam(
        torch.from_numpy(masked), tie=tie).numpy())


# ------------------------------------------ the tiled kernel's finish --
# `csrc/find_seam_tiled.cu`'s finish composes each block of R parent rows
# into one jump a column, walks the jumps from the last row up, then fills
# each block's rows.  `ops/dp.py::backtrack_blocked` is that algorithm in
# plain PyTorch; it must give `backtrack_windowed`'s seams (find_seam.cu's
# walk) and `backtrack`'s, at one block, several and a ragged last one.

R = FINISH_ROWS
BLOCK_HEIGHTS = [1, 2, R - 1, R, R + 1, 2 * R + 1, 1080]


def _blocked(P, last, tie, r=R):
    return tdp.backtrack_blocked(P, last, r, tie).numpy()


@pytest.mark.parametrize("r", [R, 8])
@pytest.mark.parametrize("h", BLOCK_HEIGHTS)
@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
def test_blocked_backtrack_on_random_parents(tie, h, r):
    # parents in {-1, 0, 1} that no DP made: the clamp at both borders
    rng = np.random.default_rng(h)
    P = torch.from_numpy(rng.integers(-1, 2, (2, h, 150)).astype(np.int8))
    last = torch.from_numpy(rng.integers(0, 3, (2, 150)).astype(np.float32))
    got = _blocked(P, last, tie, r)
    np.testing.assert_array_equal(
        got, tdp.backtrack_windowed(P, last, 64, tie).numpy())
    assert got.dtype == np.int32 and got.shape == (2, h)
    assert (np.abs(np.diff(got, axis=-1)) <= 1).all()


@pytest.mark.parametrize("h", BLOCK_HEIGHTS)
@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
def test_blocked_backtrack_on_dp_parents(tie, h):
    # tie-heavy energies: most cells tie with a neighbour, both ways
    M = tdp.cumulative_energy(torch.from_numpy(_tie_heavy((2, h, 140), h)))
    P = tdp.parent_directions(M, tie)
    got = _blocked(P, M[..., -1, :], tie)
    np.testing.assert_array_equal(
        got, tdp.backtrack_windowed(P, M[..., -1, :], 64, tie).numpy())
    np.testing.assert_array_equal(got, tdp.backtrack(M, tie=tie).numpy())


@pytest.mark.parametrize("h", [R + 1, 2 * R + 1])
@pytest.mark.parametrize("border", ["first", "last"])
@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
def test_blocked_backtrack_along_a_border(tie, border, h):
    E = np.ones((h, W), np.float32)
    col = 0 if border == "first" else W - 1
    E[:, col] = 0
    M = tdp.cumulative_energy(torch.from_numpy(E))
    got = _blocked(tdp.parent_directions(M, tie), M[-1], tie)
    assert (got == col).all()
    np.testing.assert_array_equal(got, tdp.backtrack(M, tie=tie).numpy())


@pytest.mark.parametrize("kind", ["random", "tie-heavy"])
@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
def test_blocked_backtrack_of_a_stack_with_per_image_windows(tie, kind):
    B, Hb, Wb = 4, 2 * R + 8, 256  # the Pallas kernel wants H % 8 == 0
    E = (np.random.default_rng(9).random((B, Hb, Wb), dtype=np.float32)
         if kind == "random" else _tie_heavy((B, Hb, Wb), 10))
    width = np.array([Wb, 200, 3, 17], np.int32)
    lo = np.array([0, 37, 253, 0], np.int32)
    masked = tdp.mask_energy(torch.from_numpy(E), torch.from_numpy(width),
                             torch.from_numpy(lo))
    M = tdp.cumulative_energy(masked)
    got = _blocked(tdp.parent_directions(M, tie), M[..., -1, :], tie)
    np.testing.assert_array_equal(got, np.asarray(find_seams_vec(
        jnp.asarray(E), jnp.asarray(width), jnp.asarray(lo), interpret=True,
        tie=tie)))
    np.testing.assert_array_equal(got, tdp.backtrack(M, tie=tie).numpy())
    assert (got >= lo[:, None]).all() and (got < (lo + width)[:, None]).all()
