"""The port's DCT energy (plain PyTorch, CPU) against the JAX package.

The plain version is held bit for bit against the JAX energy called
eagerly (each jnp op rounds on its own, like each torch op) and against the
independent native f32 chain.  The Pallas kernel in interpret mode is held
within `rtol=5e-5, atol=1e-7`, the tolerance of tests/test_energy_kernel.py:
interpret mode runs under jit, where XLA:CPU contracts multiply-adds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_carver_tpu.ops import dct as jdct
from dct_carver_tpu.ops import energy as jenergy
from dct_carver_tpu.pallas.energy_kernel import dct_energy_pallas
from dct_carver_tpu.utils.native import energy_map_native_f32
from dct_carver_tpu_torch import kernels
from dct_carver_tpu_torch.kernels.energy_kernel import dct_energy
from dct_carver_tpu_torch.ops import dct as tdct
from dct_carver_tpu_torch.ops import energy as tenergy

from test_native import _structured_luma


def _luma(seed=0, shape=(40, 64)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def test_taps_are_the_jax_taps():
    for n in (2, 4, 8, 16):
        np.testing.assert_array_equal(tdct._dct_matrix_np(n),
                                      jdct._dct_matrix_np(n))


@pytest.mark.parametrize("center", ["carve", "preview"])
@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_energy_equals_jax_eager(n, center):
    luma = _luma(n)
    want = np.asarray(jdct.dct_energy_map(jnp.asarray(luma), n, 0.3, 0.7,
                                          center=center))
    got = tdct.dct_energy_map(torch.from_numpy(luma), n, 0.3, 0.7,
                              center=center).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_energy_equals_native_f32(n):
    luma = _structured_luma("photo", 48, 64)
    want = energy_map_native_f32(luma, n, 0.3, 0.7)
    got = tdct.dct_energy_map(torch.from_numpy(luma), n, 0.3, 0.7).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_energy_close_to_pallas_interpret(n):
    luma = _luma(10 + n, (16, 96))
    want = np.asarray(dct_energy_pallas(jnp.asarray(luma), n, 0.3, 0.9,
                                        interpret=True))
    got = dct_energy(torch.from_numpy(luma), n, 0.3, 0.9).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-7)


def test_energy_f64_equals_jax_x64():
    import jax

    luma = _luma(3).astype(np.float64)
    with jax.enable_x64(True):
        want = np.asarray(jdct.dct_energy_map(jnp.asarray(luma), 8, 0.4,
                                              0.6))
    got = tdct.dct_energy_map(torch.from_numpy(luma), 8, 0.4, 0.6).numpy()
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_cpu_dispatch_is_the_plain_version():
    kernels.reset_launches()
    luma = torch.from_numpy(_luma(5))
    got = dct_energy(luma, 8, 0.2, 0.8)
    np.testing.assert_array_equal(
        got.numpy(), tdct.dct_energy_map(luma, 8, 0.2, 0.8).numpy())
    assert dct_energy(luma.double(), 8, 0.2, 0.8).dtype == torch.float32
    assert kernels.launch_counts()["energy"] == 0
    with pytest.raises(ValueError):
        dct_energy(luma, 5, 0.2, 0.8)


@pytest.mark.parametrize("mode", ["bt709", "bt601_studio"])
@pytest.mark.parametrize("channels", [None, 1, 3, 4])
def test_to_luma_equals_jax(mode, channels):
    rng = np.random.default_rng(7)
    shape = (20, 30) if channels is None else (20, 30, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(jenergy.to_luma(jnp.asarray(img), mode))
    got = tenergy.to_luma(torch.from_numpy(img), mode).numpy()
    np.testing.assert_array_equal(got, want)


def test_to_luma_rejects_unknown_mode():
    with pytest.raises(ValueError):
        tenergy.to_luma(torch.zeros((4, 4)), "srgb")


@pytest.mark.parametrize("kind", ["random", "constant"])
def test_normalize_to_u8_equals_jax(kind):
    rng = np.random.default_rng(11)
    e = (rng.random((24, 33), dtype=np.float32) * 5.0 if kind == "random"
         else np.full((24, 33), 0.25, np.float32))
    want = np.asarray(jenergy.normalize_to_u8(jnp.asarray(e)))
    got = tenergy.normalize_to_u8(torch.from_numpy(e)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_energy_map_from_image_equals_jax():
    img = np.random.default_rng(2).integers(0, 256, (24, 40, 3),
                                            dtype=np.uint8)
    for luma, center in (("bt709", "carve"), ("bt601_studio", "preview")):
        want = np.asarray(jenergy.energy_map(jnp.asarray(img), 4, 0.1, 0.9,
                                             luma=luma, center=center))
        got = tenergy.energy_map(torch.from_numpy(img), 4, 0.1, 0.9,
                                 luma=luma, center=center).numpy()
        np.testing.assert_array_equal(got, want)
