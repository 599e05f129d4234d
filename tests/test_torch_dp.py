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
from dct_carver_tpu.pallas.dp_kernel import find_seam_pallas
from dct_carver_tpu_torch import kernels
from dct_carver_tpu_torch.kernels.dp_kernel import find_seam
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
