"""The port's whole slice on the CPU: carve loop, Carver, api.carve, state.

The reference for whole-carve vmaps is the independent native f32 carver
(`utils/native.py::carve_native_f32`, built with -ffp-contract=off): the
port rounds every op on its own, exactly like it.  JAX's jitted carve does
not always: XLA:CPU contracts multiply-adds inside its fusions, and on
quantized or n=2 inputs its vmaps can then part from native's.  So the
port is held against native everywhere, and against JAX only on the
structured corpus of tests/test_native.py, where JAX agrees with native.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_carver_tpu import api as japi
from dct_carver_tpu.oracle import reference as oracle
from dct_carver_tpu.ops import carve as jcarve
from dct_carver_tpu.utils.native import carve_native_f32
from dct_carver_tpu_torch import api as tapi
from dct_carver_tpu_torch import kernels
from dct_carver_tpu_torch.models.carver import Carver
from dct_carver_tpu_torch.ops import carve as tcarve
from dct_carver_tpu_torch.utils.config import CarverConfig
from dct_carver_tpu_torch.utils.state import state_from_numpy, state_to_numpy

from test_native import _structured_luma

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _luma(kind, n, h=40, w=72):
    if kind == "structured":
        return _structured_luma("photo", h, w, seed=n)
    img = np.random.default_rng(n).integers(0, 256, (h, w), dtype=np.uint8)
    if kind == "quantized":
        img = (img // 64) * 64
    return img.astype(np.float32) / 255.0


@pytest.mark.parametrize("kind", ["random", "quantized", "structured"])
@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_vmaps_equal_native_f32(n, kind):
    luma = _luma(kind, n)
    tie = "rightmost" if n in (4, 16) else "leftmost"
    want = carve_native_f32(luma, 10, n, 0.3, 0.7, tie=tie)
    kernels.reset_launches()
    got = tcarve.carve_n_seams(torch.from_numpy(luma), 10, n, 0.3, 0.7,
                               tie=tie)
    np.testing.assert_array_equal(got.vmap.numpy(), want)
    assert got.width == 72 - 10
    assert sum(kernels.launch_counts().values()) == 0


def _structured_rgb(h, w, seed=1):
    planes = [_structured_luma(k, h, w, seed=seed + i)
              for i, k in enumerate(("photo", "gradient", "edges"))]
    return (np.stack(planes, axis=-1) * 255).astype(np.uint8)


@pytest.mark.parametrize("case", [
    dict(seams=-6, output_seams=True, output_energy=True),
    dict(seams=5, output_seams=True),
    dict(seams=-5, vertically=True, output_seams=True, output_energy=True),
    dict(seams=-6, tie="rightmost", output_seams=True),
    dict(seams=-4, resize_canvas=False, blocksize=4),
    dict(seams=4, resize_canvas=False, blocksize=2, textures=0.6),
])
def test_api_carve_equals_jax(case):
    case = dict(case)
    seams = case.pop("seams")
    img = _structured_rgb(40, 56)
    want = japi.carve(img, seams, **case)
    got = tapi.carve(img, seams, device="cpu", **case)
    for field in ("image", "visibility_map", "energy_image"):
        a, b = getattr(got, field), getattr(want, field)
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_api_zero_seams_and_bidirectional():
    img = _structured_rgb(32, 40)
    res = tapi.carve(img, 0, output_seams=True, output_energy=True,
                     device="cpu")
    np.testing.assert_array_equal(res.image, img)
    assert res.visibility_map.sum() == 0
    np.testing.assert_array_equal(
        res.energy_image, japi.carve(img, 0, output_energy=True).energy_image)
    from dct_carver_tpu.models.carver import Carver as JCarver

    got = Carver(img, device="cpu").resize(36, 28)
    want = JCarver(img).resize(36, 28)
    np.testing.assert_array_equal(got.image, want.image)
    assert got.image.shape == (28, 36, 3)


def test_energy_preview_equals_jax():
    from dct_carver_tpu.models.carver import Carver as JCarver

    img = _structured_rgb(24, 40)
    np.testing.assert_array_equal(
        Carver(img, blocksize=4, device="cpu").energy_preview(),
        JCarver(img, blocksize=4).energy_preview())


@pytest.mark.parametrize("strip_update", [False, True])
def test_f64_carve_equals_oracle(strip_update):
    img = np.random.default_rng(5).integers(0, 256, (32, 40, 3),
                                            dtype=np.uint8)
    ref_out, ref_vmap, _ = oracle.carve_seams(img, 5, 8, 0.3, 0.9)
    luma = torch.from_numpy(oracle.luma_bt709(img))
    state = tcarve.carve_n_seams(luma, 5, 8, 0.3, 0.9,
                                 strip_update=strip_update)
    np.testing.assert_array_equal(state.vmap.numpy(), ref_vmap)
    out = tcarve.reconstruct_removed(torch.from_numpy(img), state.vmap, 5)
    np.testing.assert_array_equal(out.numpy(), ref_out)


def test_f64_enlarge_equals_oracle():
    img = np.random.default_rng(6).integers(0, 256, (24, 30, 3),
                                            dtype=np.uint8)
    ref_out, ref_vmap = oracle.insert_seams(img, 4, 8, 0.2, 0.7)
    luma = torch.from_numpy(oracle.luma_bt709(img))
    state = tcarve.carve_n_seams(luma, 4, 8, 0.2, 0.7, strip_update=False)
    np.testing.assert_array_equal(state.vmap.numpy(), ref_vmap)
    out = tcarve.reconstruct_enlarged(torch.from_numpy(img), state.vmap, 4)
    np.testing.assert_array_equal(out.numpy(), ref_out)


def test_reconstruct_equals_jax_on_floats_and_gray():
    rng = np.random.default_rng(8)
    vmap = np.zeros((6, 9), np.int32)
    vmap[np.arange(6), rng.integers(0, 9, 6)] = 1
    for img in (rng.random((6, 9), dtype=np.float32),
                rng.integers(0, 256, (6, 9), dtype=np.uint8)):
        np.testing.assert_array_equal(
            tcarve.reconstruct_enlarged(torch.from_numpy(img),
                                        torch.from_numpy(vmap), 1).numpy(),
            np.asarray(jcarve.reconstruct_enlarged(jnp.asarray(img),
                                                   jnp.asarray(vmap), 1)))
        np.testing.assert_array_equal(
            tcarve.reconstruct_removed(torch.from_numpy(img),
                                       torch.from_numpy(vmap), 1).numpy(),
            np.asarray(jcarve.reconstruct_removed(jnp.asarray(img),
                                                  jnp.asarray(vmap), 1)))


def test_one_seam_from_a_jax_mid_carve_state():
    """The port takes a JAX state after m seams and removes seam m+1: the
    same seam, luma and origcol as JAX, bit for bit.  The energy is held
    within the Pallas interpret tolerance (tests/test_energy_kernel.py):
    JAX's strip ran jitted, with contracted multiply-adds."""
    luma = jnp.asarray(_structured_luma("photo", 40, 64))
    m = 4
    mid = jcarve.carve_n_seams(luma, m, 8, 0.3, 0.7, use_pallas=False)
    nxt = jcarve.carve_n_seams(luma, m + 1, 8, 0.3, 0.7, use_pallas=False)
    arrays = {k: np.asarray(v) for k, v in mid._asdict().items()}

    state = state_from_numpy(arrays, device="cpu")
    back = state_to_numpy(state)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)

    got = tcarve.carve_seams(state, m, 1, 8, 0.3, 0.7, strip_update=True)
    live = 64 - m - 1
    assert got.width == int(nxt.width) == live
    np.testing.assert_array_equal(got.vmap.numpy(), np.asarray(nxt.vmap))
    np.testing.assert_array_equal(got.luma.numpy(), np.asarray(nxt.luma))
    np.testing.assert_array_equal(got.origcol[:, :live].numpy(),
                                  np.asarray(nxt.origcol)[:, :live])
    np.testing.assert_allclose(got.energy[:, :live].numpy(),
                               np.asarray(nxt.energy)[:, :live],
                               rtol=5e-5, atol=1e-7)


def test_state_from_numpy_rejects_mismatched_shapes():
    arrays = state_to_numpy(tcarve.make_state(torch.zeros((4, 6))))
    arrays["vmap"] = arrays["vmap"][:, :5]
    with pytest.raises(ValueError):
        state_from_numpy(arrays, device="cpu")


@pytest.mark.parametrize("entry", ["state_from_numpy", "load_state"])
def test_state_loaders_raise_with_no_card(entry, monkeypatch, tmp_path):
    """With no device named, `state_from_numpy` and `load_state` put the
    state on the first card, as JAX's `jnp.asarray` puts it on the default
    device (dct_carver_tpu/utils/checkpoint.py:207-221): with no card
    visible they raise NO_CARD's message instead of carrying on on the
    CPU, and `device="cpu"` still loads."""
    from dct_carver_tpu_torch.utils.placement import NO_CARD
    from dct_carver_tpu_torch.utils import checkpoint as tckpt

    state = tcarve.make_state(torch.arange(24.0).reshape(4, 6) / 24)
    path = str(tmp_path / "ck.npz")
    tckpt.save_state(path, state, CarverConfig(), 1, 2)
    load = {"state_from_numpy": lambda **kw: state_from_numpy(
                state_to_numpy(state), **kw),
            "load_state": lambda **kw: tckpt.load_state(path, **kw)[0]}[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match=re.escape(NO_CARD)):
            load(**kw)
    got = load(device="cpu")
    assert got.luma.device == torch.device("cpu")
    np.testing.assert_array_equal(got.luma.numpy(), state.luma.numpy())


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import dct_carver_tpu_torch\n"
        "from dct_carver_tpu_torch import api, models, kernels\n"
        "from dct_carver_tpu_torch.kernels import build\n"
        "from dct_carver_tpu_torch.utils import state\n"
        "from dct_carver_tpu_torch.parallel import shards, spatial\n"
        "from dct_carver_tpu_torch.parallel import dryrun, multihost\n"
        "assert multihost.process_health()['healthy']\n"
        "dryrun.dryrun_multichip(2, devices=['cpu'] * 2)\n"
        "from dct_carver_tpu_torch.models import retarget\n"
        "from dct_carver_tpu_torch.ui import server\n"
        "from dct_carver_tpu_torch.utils import debug, profiling\n"
        "rt = retarget.InteractiveRetargeter(np.zeros((16, 24, 3), np.uint8),"
        " 3, device='cpu')\n"
        "assert rt.at_width(22).shape == (16, 22, 3)\n"
        "server.CarverApp(np.zeros((8, 8), np.uint8), device='cpu').meta()\n"
        "img = np.zeros((16, 24, 3), np.uint8)\n"
        "api.carve(img, -2, device='cpu')\n"
        "res = spatial.spatial_carve_n_seams(np.ones((16, 24), np.float32),"
        " 2, devices=['cpu'] * 2)\n"
        "assert res.width == 22\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m.startswith('dct_carver_tpu.') or "
        "m == 'dct_carver_tpu' for m in sys.modules)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def test_config_validation():
    # pluggable energies are ported: the knob resolves and carves
    cfg = CarverConfig(energy="grad_xabs")
    assert cfg.energy_function.name == "grad_xabs" and cfg.radius == 1
    res = tapi.carve(np.zeros((8, 12, 3), np.uint8), -2, energy="grad_xabs",
                     device="cpu")
    assert res.image.shape == (8, 10, 3)
    with pytest.raises(ValueError, match="unknown builtin energy"):
        CarverConfig(energy="grad_bogus")
    assert CarverConfig(parallel="spatial").parallel == "spatial"
    with pytest.raises(ValueError):
        CarverConfig(parallel="sideways")
    with pytest.raises(ValueError):
        CarverConfig(blocksize=5)
    with pytest.raises(ValueError):
        CarverConfig(edges=1.5)
    with pytest.raises(ValueError):
        CarverConfig(tie="middle")
    assert CarverConfig(energy="dct").radius == 4


def test_unported_routes_raise(tmp_path, monkeypatch):
    img = np.zeros((2, 16, 16, 3), np.uint8)
    # a stack on the single-image route reaches the Carver, which takes
    # one image (the batch route is tests/test_torch_batch.py)
    with pytest.raises(ValueError, match=r"\(H, W\) or \(H, W, C\)"):
        tapi.carve(img, -2, parallel="none", device="cpu")
    with pytest.raises(ValueError, match=r"\(H, W\) or \(H, W, C\)"):
        Carver(img, device="cpu")
    # the spatial route is ported (tests/test_torch_spatial.py)
    res = tapi.carve(img[0], -2, parallel="spatial", devices=["cpu"] * 2)
    assert res.image.shape == (16, 14, 3)
    # the interactive and ui commands are ported: on the card by default,
    # so with no card visible they raise unless --device cpu asks for the
    # CPU (tests/test_torch_cli.py runs them there)
    from dct_carver_tpu_torch.cli import main as cli_main
    from dct_carver_tpu_torch.utils.image import save_ppm

    inp = str(tmp_path / "in.ppm")
    save_ppm(inp, img[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["ui", inp, "--port", "0"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["interactive", inp, str(tmp_path / "o_{w}.ppm"),
                  "--max-seams", "2"])
    assert not list(tmp_path.glob("o_*"))
    with pytest.raises(ValueError):
        tapi.carve(img[0], -16, device="cpu")


def test_rigidity_carve_equals_jax():
    luma = _structured_luma("edges", 32, 48)
    want = jcarve.carve_n_seams(jnp.asarray(luma), 5, 8, 0.3, 0.7,
                                use_pallas=False, delta_x=2, rigidity=0.5)
    got = tcarve.carve_n_seams(torch.from_numpy(luma), 5, 8, 0.3, 0.7,
                               delta_x=2, rigidity=0.5)
    np.testing.assert_array_equal(got.vmap.numpy(), np.asarray(want.vmap))
