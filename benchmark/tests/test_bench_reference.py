"""The plain reference against the program's CPU path at small sizes (both
exact: every op rounded on its own), and the control, the reference one
precision lower, refused by the same comparison."""

import numpy as np
import pytest
import torch

from benchlib.check import Checks, differing
from benchlib.images import photos
from reference import carve as ref


def _images(seed, B, H, W):
    return photos(seed, B, H, W, device="cpu")


@pytest.mark.parametrize("n", [8, 16])
def test_width_carve_equals_the_program(n):
    from dct_carver_tpu_torch import api

    img = _images(n, 1, 40, 60)
    want = api.carve(img[0], -7, blocksize=n, device="cpu", output_seams=True)
    out, vmap = ref.carve(img, 7, n)
    assert differing(out[0], want.image) == 0
    assert differing(vmap[0], want.visibility_map) == 0


def test_both_axes_equal_the_program():
    from dct_carver_tpu_torch.models.carver import Carver
    from dct_carver_tpu_torch.utils.config import CarverConfig

    img = _images(3, 1, 44, 56)
    want = Carver(img[0], CarverConfig(blocksize=16, output_seams=True),
                  device="cpu").resize(50, 40)
    out, (vw, vh) = ref.resize(img, 6, 4, 16)
    assert differing(out[0], want.image) == 0
    assert differing(vw[0], want.visibility_map) == 0
    assert vh.shape == (1, 50, 44)


def test_a_stack_equals_the_program_over_several_devices():
    from dct_carver_tpu_torch import api

    st = _images(4, 5, 32, 40)
    want = api.carve(st, -5, parallel="batch", devices=["cpu"] * 2,
                     output_seams=True)
    out, vmaps = ref.carve(st, 5, 8)
    assert differing(out, want.image) == 0
    assert differing(vmaps, want.visibility_map) == 0


def test_walk_equals_a_walk_row_by_row():
    g = torch.Generator().manual_seed(0)
    H, S, w = 37, 3, 11
    up = torch.randint(-1, 2, (H - 1, S, w), generator=g, dtype=torch.int8)
    up[:, :, 0].clamp_(min=0)
    up[:, :, -1].clamp_(max=0)
    j = torch.tensor([0, 5, 10])
    got = ref._walk(up, j)
    cur = j.clone()
    for i in range(H - 1, -1, -1):
        assert torch.equal(got[:, i], cur)
        if i:
            cur = cur + up[i - 1, torch.arange(S), cur]


def test_the_control_is_refused():
    """bfloat16 in the program's place: the comparison must take it for
    wrong (the chip's readings at the cells' sizes are in PERF.md)."""
    st = _images(5, 2, 40, 64)
    want = ref.carve(st, 6, 8)
    got = ref.carve(st, 6, 8, dtype=torch.bfloat16)
    checks = Checks()
    checks.add(got[0], want[0], [got[1]], [want[1]])
    assert not checks.correct()
    assert checks.values["vmap_diff"] > 0
    same = Checks()
    same.add(want[0], want[0], [want[1]], [want[1]])
    assert same.correct()


def test_the_photos_are_made_from_the_seed():
    a = photos(2**31 + 5, 2, 24, 32, device="cpu")
    assert a.dtype == np.uint8 and a.shape == (2, 24, 32, 3)
    assert np.array_equal(a, photos(2**31 + 5, 2, 24, 32, device="cpu"))
    assert not np.array_equal(a, photos(2**31 + 6, 2, 24, 32, device="cpu"))
    # flat shapes: runs of equal pixels, whose equal energies tie the DP
    assert (np.diff(a.astype(int), axis=2) == 0).all(axis=-1).mean() > 0.1
