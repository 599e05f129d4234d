"""The randomized and forced-tie corpora of tests/test_fuzz.py, run against
the port.

The port's whole-carve vmaps are held against the independent native f32
carver (`utils/native.py::carve_native_f32`, -ffp-contract=off, like the
port's separately rounded ops), the NumPy oracle, and the JAX package's
scan carve where it agrees with native (ROADMAP Queue 3: XLA:CPU contracts
multiply-adds inside `jit`).  Plugged energies on the forced-tie corpus are
held against the oracle DP driven by the oracle's gradient energies.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_carver_tpu.ops.carve import carve_n_seams as j_carve_n_seams
from dct_carver_tpu.oracle import reference as oracle
from dct_carver_tpu.utils.native import carve_native_f32
from dct_carver_tpu_torch.ops.carve import carve_n_seams
from dct_carver_tpu_torch.ops.energy_fn import builtin_energy

from test_fuzz import _image, _tie_corpus


def _port_vmap(luma, n, blocksize, edges, textures, **kw):
    return carve_n_seams(torch.from_numpy(luma), n, blocksize, edges,
                         textures, **kw).vmap.numpy()


@pytest.mark.parametrize("strip", [True, False])
@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
@pytest.mark.parametrize("kind", ["constant", "stripes", "two_blobs"])
def test_forced_tie_port_agrees(kind, tie, strip):
    """Under forced exact ties the port picks the seams of the oracle, the
    native f32 carver and the JAX scan carve, at both tie settings."""
    rng = np.random.default_rng(7)
    h, w, n = 16, 48, 4
    img = _tie_corpus(rng, h, w, kind)
    luma = np.asarray(oracle.luma_bt709(img), np.float32)
    _, ref_vmap, _ = oracle.carve_seams(img, n, 8, 0.3, 0.7, tie=tie)
    got = _port_vmap(luma, n, 8, 0.3, 0.7, tie=tie, strip_update=strip)
    np.testing.assert_array_equal(got, ref_vmap, err_msg=f"{tie} {kind}")
    np.testing.assert_array_equal(
        got, carve_native_f32(luma, n, 8, 0.3, 0.7, tie=tie))
    scan = j_carve_n_seams(jnp.asarray(luma), n, 8, 0.3, 0.7,
                           use_pallas=False, tie=tie, strip_update=strip)
    np.testing.assert_array_equal(got, np.asarray(scan.vmap))


@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
@pytest.mark.parametrize("energy", ["grad_xabs", "grad_sumabs", "grad_norm"])
@pytest.mark.parametrize("kind", ["constant", "stripes", "two_blobs"])
def test_forced_tie_plugged_energy(kind, energy, tie):
    rng = np.random.default_rng(8)
    h, w, n = 12, 40, 3
    img = _tie_corpus(rng, h, w, kind)
    luma = np.asarray(oracle.luma_bt709(img), np.float32)
    cur = luma.copy()
    origcol = np.broadcast_to(np.arange(w, dtype=np.int32), (h, w)).copy()
    ref = np.zeros((h, w), np.int32)
    for k in range(1, n + 1):
        seam = oracle.find_seam(oracle.gradient_energy_map(cur, energy),
                                tie=tie)
        ref[np.arange(h), origcol[np.arange(h), seam]] = k
        cur = oracle._remove_seam(cur, seam)
        origcol = oracle._remove_seam(origcol, seam)
    got = _port_vmap(luma, n, 8, 0.0, 1.0, tie=tie,
                     energy_fn=builtin_energy(energy))
    np.testing.assert_array_equal(got, ref, err_msg=f"{energy} {tie} {kind}")


@pytest.mark.parametrize("trial", range(12))
def test_random_config_carve_parity(trial):
    """test_fuzz.py's random grid over shape, blocksize, weights, seams,
    image kind and strip on/off, against native and the oracle."""
    rng = np.random.default_rng(1000 + trial)
    h = int(rng.integers(12, 40))
    w = int(rng.integers(24, 72))
    blocksize = int(rng.choice([2, 4, 8, 16]))
    slider = float(rng.choice([0.0, 0.25, 0.5, 1.0]))
    edges, textures = 1.0 - slider, slider
    n = int(rng.integers(1, min(8, w - 2)))
    kind = ["noise", "smooth", "quantized", "structured"][trial % 4]
    strip = bool(trial % 2)

    img = _image(rng, h, w, kind)
    luma = np.asarray(oracle.luma_bt709(img), np.float32)
    msg = (f"trial={trial} h={h} w={w} n={n} bs={blocksize} s={slider} "
           f"kind={kind} strip={strip}")
    got = _port_vmap(luma, n, blocksize, edges, textures, strip_update=strip)
    np.testing.assert_array_equal(
        got, carve_native_f32(luma, n, blocksize, edges, textures),
        err_msg=msg)
    _, ref_vmap, _ = oracle.carve_seams(img, n, blocksize, edges, textures)
    np.testing.assert_array_equal(got, ref_vmap, err_msg=msg)


@pytest.mark.parametrize("trial", range(6))
def test_random_config_generalized_dp_parity(trial):
    """test_fuzz.py's delta_x/rigidity sweep against the oracle's
    generalized recurrence and the JAX scan carve."""
    rng = np.random.default_rng(2000 + trial)
    h = int(rng.integers(12, 32))
    w = int(rng.integers(24, 56))
    dx = int(rng.integers(1, 4))
    rig = float(rng.choice([0.0, 0.3, 1.0, 2.5]))
    n = int(rng.integers(1, 5))
    img = _image(rng, h, w, ["noise", "quantized", "structured"][trial % 3])
    luma = np.asarray(oracle.luma_bt709(img), np.float32)
    msg = f"trial={trial} h={h} w={w} n={n} dx={dx} rig={rig}"
    _, ref_vmap, _ = oracle.carve_seams(img, n, 8, 0.2, 0.8,
                                        delta_x=dx, rigidity=rig)
    got = _port_vmap(luma, n, 8, 0.2, 0.8, delta_x=dx, rigidity=rig)
    np.testing.assert_array_equal(got, ref_vmap, err_msg=msg)
    want = j_carve_n_seams(jnp.asarray(luma), n, 8, 0.2, 0.8,
                           delta_x=dx, rigidity=rig)
    np.testing.assert_array_equal(got, np.asarray(want.vmap), err_msg=msg)
