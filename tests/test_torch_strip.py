"""The port's per-row strip update (plain PyTorch, CPU).

A strip recompute must equal a full recompute on the live columns, bit for
bit; and whole carves with strip updates must give the vmaps of the JAX
carve whose strip runs through the packed Pallas kernels (interpret mode),
at the shapes of tests/test_strip_kernel.py.  That carve is jitted, and
XLA:CPU contracts multiply-adds inside it, so its final energy can differ
from a separately rounded one in the last bit; the port's final energy is
held instead against the JAX energy computed eagerly on JAX's final luma.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_carver_tpu.ops.carve import carve_n_seams as j_carve_n_seams
from dct_carver_tpu.ops.dct import dct_energy_map as j_dct_energy_map
from dct_carver_tpu_torch import kernels
from dct_carver_tpu_torch.kernels.apply_kernel import apply_seam
from dct_carver_tpu_torch.kernels.dp_kernel import find_seam
from dct_carver_tpu_torch.kernels.energy_kernel import dct_energy
from dct_carver_tpu_torch.kernels.strip_kernel import strip_update
from dct_carver_tpu_torch.ops import carve as tcarve
from dct_carver_tpu_torch.ops.dp import find_seam as plain_find_seam


def _seam(E, delta_x):
    if delta_x == 1:
        return find_seam(E, E.shape[1])
    return plain_find_seam(E, delta_x, 0.0).to(torch.int32)


@pytest.mark.parametrize("n,delta_x", [(2, 1), (4, 1), (8, 1), (16, 1),
                                       (8, 2)])
def test_strip_equals_full_recompute(n, delta_x):
    rng = np.random.default_rng(n + delta_x)
    luma = torch.from_numpy(rng.random((40, 96), dtype=np.float32))
    W = luma.shape[1]
    E = dct_energy(luma, n, 0.3, 0.8)
    for _ in range(3):  # a few seams, so the strip meets a compacted state
        seam = _seam(E, delta_x)
        luma, _, E = apply_seam(luma, torch.zeros_like(luma, dtype=torch.int32),
                                E, seam, W)
        W -= 1
        strip_update(luma, E, seam, n, 0.3, 0.8, delta_x=delta_x)
        full = dct_energy(luma, n, 0.3, 0.8)
        np.testing.assert_array_equal(E[:, :W].numpy(), full[:, :W].numpy())


def test_strip_rejects_narrow_buffers():
    luma = torch.zeros((8, 19))
    with pytest.raises(ValueError):
        strip_update(luma, torch.zeros((8, 19)),
                     torch.zeros(8, dtype=torch.int32), 8, 0.0, 1.0)


@pytest.mark.parametrize("n", [4, 8])
def test_narrow_image_carves_with_full_recompute(n):
    """Widths below the strip fall back to full recomputes, like JAX's guard
    (dct_carver_tpu/ops/carve.py:412-417)."""
    rng = np.random.default_rng(n)
    luma = rng.random((16, 11), dtype=np.float32)
    strip = tcarve.carve_n_seams(torch.from_numpy(luma), 4, n, 0.2, 0.9)
    full = tcarve.carve_n_seams(torch.from_numpy(luma), 4, n, 0.2, 0.9,
                                strip_update=False)
    np.testing.assert_array_equal(strip.vmap.numpy(), full.vmap.numpy())


@pytest.mark.parametrize("hw,blocksize", [((16, 256), 4), ((24, 384), 8),
                                          ((48, 384), 8), ((40, 512), 16)])
def test_carve_equals_jax_packed_strip(hw, blocksize):
    H, W = hw
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(H, W), dtype=np.uint8)
    luma = img.astype(np.float32) / 255.0
    want = j_carve_n_seams(jnp.asarray(luma), 5, blocksize, 0.3, 0.8,
                           strip_update=True, use_pallas=True)
    kernels.reset_launches()
    got = tcarve.carve_n_seams(torch.from_numpy(luma), 5, blocksize, 0.3, 0.8)
    np.testing.assert_array_equal(got.vmap.numpy(), np.asarray(want.vmap))
    np.testing.assert_array_equal(got.luma.numpy(), np.asarray(want.luma))
    live = W - 5
    eager = np.asarray(j_dct_energy_map(want.luma, blocksize, 0.3, 0.8))
    np.testing.assert_array_equal(got.energy[:, :live].numpy(),
                                  eager[:, :live])
    assert got.width == int(want.width) == live
    assert sum(kernels.launch_counts().values()) == 0
