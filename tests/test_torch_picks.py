"""The pick rule the DCT kernels rely on (`csrc/energy_chain.cuh`), in plain
PyTorch: each ky's row of atoms gives a (value, rank) pick, and the picks
combine in any order to the sequential running argmax of
`energy_from_bands` (largest |coefficient|, then largest rank kx*n + ky).
The strip kernel combines a pixel's per-ky picks across warp lanes by a
butterfly of shuffles, the energy kernel one ky after another; both must
give the sequential loop's bits.  Tie-heavy quantized luma makes many
atoms tie exactly, edges against textures included.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_carver_tpu.ops import dct as jdct
from dct_carver_tpu_torch.ops import dct as tdct

EDGES, TEXTURES = 0.3, 0.7


def _bands(n, seed, levels=3):
    """Bands of a luma quantized to `levels` values in [0, 1]."""
    rng = np.random.default_rng(seed)
    luma = (rng.integers(0, levels, (14, 40)) / (levels - 1)).astype(
        np.float32)
    return luma, tdct.rows_to_bands(torch.from_numpy(luma), n)


def _butterfly(picks):
    """The strip kernel's order: lane ky takes lane ky ^ off's pick for
    off = n/2, ..., 1; lane 0 ends with the result."""
    lanes = list(picks)
    off = len(lanes) // 2
    while off:
        lanes = [tdct.combine_picks(lanes[k], lanes[k ^ off])
                 for k in range(len(lanes))]
        off //= 2
    return lanes[0]


def _tree(picks):
    while len(picks) > 1:
        picks = [tdct.combine_picks(*picks[k:k + 2]) if k + 1 < len(picks)
                 else picks[k] for k in range(0, len(picks), 2)]
    return picks[0]


ORDERS = {
    "in ky order": lambda p: functools.reduce(tdct.combine_picks, p),
    "reversed": lambda p: functools.reduce(tdct.combine_picks, p[::-1]),
    "pairwise tree": _tree,
    "butterfly": _butterfly,
    "shuffled": lambda p: functools.reduce(tdct.combine_picks, [
        p[k] for k in np.random.default_rng(len(p)).permutation(len(p))]),
}


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_per_ky_picks_combine_to_energy_from_bands(n, order):
    _, bands = _bands(n, 20 + n)
    got = tdct.pick_energy(ORDERS[order](tdct.ky_picks(bands, n)), n, EDGES,
                           TEXTURES)
    want = tdct.energy_from_bands(bands, n, EDGES, TEXTURES)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_picks_equal_jax_energy_from_bands(n):
    luma, bands = _bands(n, 30 + n, levels=2)
    got = tdct.pick_energy(_butterfly(tdct.ky_picks(bands, n)), n, EDGES,
                           TEXTURES)
    jbands = jdct.rows_to_bands(jnp.asarray(luma), n)
    want = np.asarray(jdct.energy_from_bands(jbands, n, EDGES, TEXTURES))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_flat_windows_tie_everywhere(n):
    # a zero luma: every coefficient is exactly 0, so all n*n - 1 atoms tie
    # and the largest rank, (n-1)*n + n-1 (a texture atom), wins
    bands = tdct.rows_to_bands(torch.zeros((6, 20)), n)
    picks = tdct.ky_picks(bands, n)
    v, rank = _butterfly(picks)
    assert bool((rank == n * n - 1).all())
    assert torch.equal(tdct.pick_energy((v, rank), n, EDGES, TEXTURES),
                       tdct.energy_from_bands(bands, n, EDGES, TEXTURES))


def test_combine_is_a_lexicographic_maximum():
    v = torch.tensor([1.0, 1.0, 2.0, -np.inf])
    r = torch.tensor([5, 7, 0, -1], dtype=torch.int32)
    v2 = torch.tensor([1.0, 1.0, 1.0, -np.inf])
    r2 = torch.tensor([7, 5, 9, -1], dtype=torch.int32)
    for a, b in (((v, r), (v2, r2)), ((v2, r2), (v, r))):
        cv, cr = tdct.combine_picks(a, b)
        assert cv.tolist() == [1.0, 1.0, 2.0, -np.inf]
        assert cr.tolist() == [7, 7, 0, -1]
