"""The port's precompute-once / slide-many retargeter
(`dct_carver_tpu_torch/models/retarget.py`) on the CPU.

It is held against the JAX package's `InteractiveRetargeter` on the
structured corpus of tests/test_native.py, where JAX's jitted carve agrees
with the native f32 carver (tests/test_torch_carve.py says why not
elsewhere), and on random images against the port's own `api.carve` at
every seam count of its range (the seams are nested: the first s of a
precompute are an s-seam carve's) and its vmap against the native f32
carver.
"""

import numpy as np
import pytest
import torch

from dct_carver_tpu.models.retarget import InteractiveRetargeter as JRetargeter
from dct_carver_tpu.utils.native import carve_native_f32
from dct_carver_tpu_torch import api as tapi
from dct_carver_tpu_torch.models.retarget import InteractiveRetargeter
from dct_carver_tpu_torch.ops.energy import to_luma

from test_native import _structured_luma

H0, W0 = 32, 44
MAX = 6


def _structured(channels, seed=1):
    """A u8 image of the structured corpus: grey, or one kind a channel."""
    kinds = ("photo", "gradient", "edges")[:channels or 1]
    planes = [_structured_luma(k, H0, W0, seed=seed + i)
              for i, k in enumerate(kinds)]
    img = (np.stack(planes, axis=-1) * 255).astype(np.uint8)
    return img if channels else img[..., 0]


@pytest.mark.parametrize("case", [
    dict(channels=None, blocksize=2, tie="leftmost"),
    dict(channels=None, blocksize=4, tie="rightmost"),
    dict(channels=None, blocksize=8, tie="leftmost", vertical=True),
    dict(channels=None, blocksize=16, tie="rightmost"),
    dict(channels=3, blocksize=8, tie="rightmost"),
    dict(channels=3, blocksize=4, tie="leftmost", vertical=True),
    dict(channels=3, blocksize=16, tie="leftmost", edges=0.3, textures=0.7),
    dict(channels=3, energy="grad_norm", tie="rightmost"),
    dict(channels=None, energy="grad_norm", vertical=True),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_retargeter_equals_jax(case):
    """`visibility_map` and `at_width` at every width of the range equal
    the JAX package's, element for element."""
    case = dict(case)
    img = _structured(case.pop("channels"))
    vertical = case.get("vertical", False)
    got = InteractiveRetargeter(img, MAX, device="cpu", **case)
    want = JRetargeter(img, MAX, **case)
    np.testing.assert_array_equal(got.visibility_map, want.visibility_map)
    dim = img.shape[0] if vertical else img.shape[1]
    for w in range(dim - MAX, dim + MAX + 1):
        a, b = got.at_width(w), np.asarray(want.at_width(w))
        assert a.dtype == b.dtype and a.shape == b.shape, w
        np.testing.assert_array_equal(a, b, err_msg=f"width {w}")
    np.testing.assert_array_equal(got.at_delta(-2), want.at_delta(-2))


@pytest.mark.parametrize("case", [
    dict(c=3, blocksize=8, tie="leftmost"),
    dict(c=None, blocksize=4, tie="rightmost"),
    dict(c=3, blocksize=2, tie="rightmost", vertical=True),
    dict(c=3, blocksize=16, tie="leftmost", edges=0.3, textures=0.7),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_nested_seams_equal_api_carve(case, make_image):
    """On random images the slide at every seam count of the range equals
    a carve of that many seams, removal and insertion, and the precomputed
    vmap equals the native f32 carver's on the same luma."""
    case = dict(case)
    img = make_image(24, 36, c=case.pop("c"))
    vertical = case.pop("vertical", False)
    knobs = {"blocksize": 8, "edges": 0.0, "textures": 1.0, **case}
    n = 2 * MAX
    rt = InteractiveRetargeter(img, n, vertical=vertical, device="cpu",
                               **knobs)
    carve_img = np.swapaxes(img, 0, 1) if vertical else img
    luma = to_luma(torch.from_numpy(np.ascontiguousarray(carve_img))).numpy()
    np.testing.assert_array_equal(
        rt.visibility_map,
        carve_native_f32(luma, n, knobs["blocksize"], knobs["edges"],
                         knobs["textures"], tie=knobs["tie"]))
    dim = img.shape[0] if vertical else img.shape[1]
    for s in range(-n, n + 1):
        want = tapi.carve(img, s, vertically=vertical, device="cpu",
                          **knobs).image
        got = rt.at_width(dim + s)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"{s} seams")


def test_slides_own_their_buffers(make_image):
    """What `at_width` and `visibility_map` return is the caller's: writing
    to it leaves the retargeter as it was."""
    img = make_image(16, 24, c=3)
    rt = InteractiveRetargeter(img, 4, device="cpu")
    vm = rt.visibility_map
    for out in (rt.at_width(24), rt.at_width(21), rt.at_width(27), vm):
        out[...] = 0
    np.testing.assert_array_equal(rt.at_width(24), img)
    assert rt.visibility_map.max() == 4
    np.testing.assert_array_equal(rt.at_width(21),
                                  tapi.carve(img, -3, device="cpu").image)


def test_range_errors(make_image):
    img = make_image(12, 20, c=3)
    with pytest.raises(ValueError, match="max_seams must be < width"):
        InteractiveRetargeter(img, 20, device="cpu")
    with pytest.raises(ValueError, match="max_seams must be < width"):
        InteractiveRetargeter(img, 12, vertical=True, device="cpu")
    rt = InteractiveRetargeter(img, 3, device="cpu")
    for w in (16, 24, 0):
        with pytest.raises(ValueError, match=r"outside precomputed range "
                                             r"±3 of 20"):
            rt.at_width(w)
    with pytest.raises(ValueError, match="outside precomputed range"):
        rt.at_delta(4)
    # parallel= is accepted and ignored, as in the JAX package
    par = InteractiveRetargeter(img, 3, parallel="spatial", device="cpu")
    np.testing.assert_array_equal(par.visibility_map, rt.visibility_map)


def test_no_card_raises(monkeypatch, make_image):
    """With no card visible the retargeter raises unless the CPU is asked
    for; it never carries on on the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = make_image(12, 20, c=3)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            InteractiveRetargeter(img, 2, device=device)
    assert InteractiveRetargeter(img, 2, device="cpu").device.type == "cpu"
