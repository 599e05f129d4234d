"""The batch route's default placement, on stand-in cards.

With no devices named and a bare "cuda", `parallel/mesh.py::carve_batch`,
`api.carve(parallel="batch")` and the CLI's `batch` command split the
batch over every visible card, as JAX's `carve_batch(mesh=None)` shards it
over every device (`dct_carver_tpu/parallel/mesh.py`); a named card or a
named mesh keeps its meaning.  There is no card here: `torch.cuda` reports
CARDS stand-in cards, and each chunk's carve, which would run on its card,
runs on the CPU with the card it was meant for recorded, as is the device
the chunks are joined on.
"""

import numpy as np
import pytest
import torch

from dct_carver_tpu.parallel import mesh as jmesh
from dct_carver_tpu_torch import api as tapi
from dct_carver_tpu_torch import cli
from dct_carver_tpu_torch.parallel import mesh as tmesh
from dct_carver_tpu_torch.utils.image import load_image, save_image

CARDS = 4
B, H, W, SEAMS = 6, 16, 24, 3


def _cuda(*indices):
    return [torch.device("cuda", i) for i in indices]


# placement: (carve_batch's `devices`, api.carve's (device, devices), the
# CLI's --device or None, the cards the chunks go to)
PLACEMENTS = {
    "default": (None, (None, None), None, _cuda(*range(CARDS))),
    "bare cuda": (None, ("cuda", None), "cuda",
                  _cuda(*range(CARDS))),
    "cuda:1": (["cuda:1"], ("cuda:1", None), "cuda:1", _cuda(1)),
    "named mesh": (["cuda:2", "cuda:3"], (None, ["cuda:2", "cuda:3"]), None,
                   _cuda(2, 3)),
}


@pytest.fixture
def cards(monkeypatch):
    """CARDS stand-in cards; yields the cards each chunk was carved for and
    the devices the chunks were joined on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: CARDS)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    seen = {"chunks": [], "joined on": []}
    carve_chunk = tmesh._carve_chunk

    def chunk(images, dev, *args, **kw):
        seen["chunks"].append(dev)
        return carve_chunk(images, torch.device("cpu"), *args, **kw)

    def join(parts, home):
        seen["joined on"].append(home)
        return torch.cat(parts)

    monkeypatch.setattr(tmesh, "_carve_chunk", chunk)
    monkeypatch.setattr(tmesh, "_join", join)
    return seen


@pytest.fixture
def images(make_image):
    return np.stack([make_image(H, W, c=3) for _ in range(B)])


def _want(images):
    """The port's carve on the CPU, and JAX's over its default mesh (every
    device of the 8-device CPU mesh)."""
    out, vm = tmesh.carve_batch(images, SEAMS, devices=["cpu"])
    jout, jvm = jmesh.carve_batch(images, SEAMS)
    np.testing.assert_array_equal(vm.numpy(), np.asarray(jvm))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    return out.numpy(), vm.numpy()


@pytest.mark.parametrize("placement", list(PLACEMENTS))
def test_carve_batch_placement(cards, images, placement):
    devices, _, _, want = PLACEMENTS[placement]
    out, vm = tmesh.carve_batch(images, SEAMS, devices=devices)
    assert cards["chunks"] == want
    assert cards["joined on"] == [want[0]] * 2
    w_out, w_vm = _want(images)
    np.testing.assert_array_equal(vm.numpy(), w_vm)
    np.testing.assert_array_equal(out.numpy(), w_out)


@pytest.mark.parametrize("placement", list(PLACEMENTS))
def test_api_batch_placement(cards, images, placement):
    _, (device, devices), _, want = PLACEMENTS[placement]
    got = tapi.carve(images, -SEAMS, parallel="batch", device=device,
                     devices=devices, output_seams=True)
    assert cards["chunks"] == want
    w_out, w_vm = _want(images)
    np.testing.assert_array_equal(got.image, w_out)
    np.testing.assert_array_equal(got.visibility_map, w_vm)


@pytest.mark.parametrize("placement", ["default", "bare cuda", "cuda:1"])
def test_cli_batch_placement(cards, images, placement, tmp_path,
                             monkeypatch):
    monkeypatch.setenv("DCT_CARVER_STATE_DIR", str(tmp_path / "state"))
    _, _, device, want = PLACEMENTS[placement]
    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    for i, im in enumerate(images):
        save_image(str(src / f"im{i}.ppm"), im)
    argv = ["batch", str(src), str(dst), "--seams", str(SEAMS)]
    assert cli.main(argv + (["--device", device] if device else [])) == 0
    assert cards["chunks"] == want
    w_out, _ = _want(images)
    for i in range(B):
        np.testing.assert_array_equal(load_image(str(dst / f"im{i}.ppm")),
                                      w_out[i])
