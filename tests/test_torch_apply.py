"""The port's seam apply (plain PyTorch, CPU) against the Pallas apply kernel
in interpret mode — the four modes of tests/test_apply_kernel.py.

Luma is compared in full (the edge fill included); origcol and energy on
the live columns, since the dead region is garbage by contract.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_carver_tpu.pallas.apply_kernel import apply_seam_pallas, new_edge_value
from dct_carver_tpu_torch import kernels
from dct_carver_tpu_torch.kernels.apply_kernel import apply_seam


def _case(mode):
    rng = np.random.default_rng(3)
    H, W = 16, 256
    luma = rng.random((H, W), dtype=np.float32)
    origcol = rng.integers(0, 4 * W, (H, W)).astype(np.int32)
    energy = rng.random((H, W), dtype=np.float32)
    width = W - 5 if mode == "shrunk" else W
    if mode == "interior":
        seam = (np.cumsum(rng.integers(-1, 2, H)) + 100) % (width - 2) + 1
    elif mode == "left":
        seam = np.minimum(np.arange(H), 2)
    elif mode == "right-edge":
        seam = np.full(H, width - 1)  # removes the logical edge column
    else:
        seam = np.full(H, width - 3)
    return luma, origcol, energy, seam.astype(np.int32), width


@pytest.mark.parametrize("mode", ["interior", "left", "right-edge", "shrunk"])
def test_apply_equals_pallas_interpret(mode):
    luma, origcol, energy, seam, width = _case(mode)
    w = jnp.asarray(width, jnp.int32)
    edge = new_edge_value(jnp.asarray(luma), jnp.asarray(seam), w)
    want = [np.asarray(a) for a in apply_seam_pallas(
        jnp.asarray(luma), jnp.asarray(origcol), jnp.asarray(energy),
        jnp.asarray(seam), edge, w, interpret=True)]
    kernels.reset_launches()
    got = [t.numpy() for t in apply_seam(
        torch.from_numpy(luma), torch.from_numpy(origcol),
        torch.from_numpy(energy), torch.from_numpy(seam), width)]
    live = width - 1
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1][:, :live], want[1][:, :live])
    np.testing.assert_array_equal(got[2][:, :live], want[2][:, :live])
    assert got[1].dtype == np.int32 and got[2].dtype == np.float32
    assert kernels.launch_counts()["apply"] == 0


def test_apply_leaves_its_inputs_alone():
    luma, origcol, energy, seam, width = _case("interior")
    ins = [torch.from_numpy(a.copy()) for a in (luma, origcol, energy)]
    apply_seam(*ins, torch.from_numpy(seam), width)
    for t, a in zip(ins, (luma, origcol, energy)):
        np.testing.assert_array_equal(t.numpy(), a)
    with pytest.raises(ValueError):
        apply_seam(*ins, torch.from_numpy(seam), 1)
