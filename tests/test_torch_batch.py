"""The port's batch route (`parallel="batch"`) on the CPU.

The batched seam DP is held bit for bit against the JAX package's batch DP,
`pallas/batch_dp_kernel.py::find_seams_vec`, in interpret mode: the DP only
adds and compares, so no rounding can differ.  The batched energy, apply and
strip must give each image what the port's single-image plain versions give
it.  The whole route is held against JAX `carve_batch` (through JAX
`api.carve(parallel="batch")`, on the 8-device CPU mesh of conftest.py) on
the random `make_image` corpus at n=8, where jitted JAX agrees with the
native f32 carver; at n=2 JAX's jitted energies part from native's
(XLA:CPU contracts multiply-adds, ROADMAP Queue 3), so there every image's
vmap is held against `carve_native_f32` instead.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_carver_tpu import api as japi
from dct_carver_tpu.pallas.batch_dp_kernel import find_seams_vec
from dct_carver_tpu.parallel import mesh as jmesh
from dct_carver_tpu.utils.native import carve_native_f32
from dct_carver_tpu_torch import api as tapi
from dct_carver_tpu_torch import kernels
from dct_carver_tpu_torch.kernels.apply_kernel import apply_seam
from dct_carver_tpu_torch.kernels.dp_kernel import find_seam, find_seams
from dct_carver_tpu_torch.kernels.energy_kernel import dct_energy
from dct_carver_tpu_torch.kernels.strip_kernel import strip_update
from dct_carver_tpu_torch.models.carver import Carver
from dct_carver_tpu_torch.ops import carve as tcarve
from dct_carver_tpu_torch.ops import dp as tdp
from dct_carver_tpu_torch.ops.energy import normalize_to_u8, to_luma
from dct_carver_tpu_torch.parallel import mesh as tmesh
from dct_carver_tpu_torch.utils.state import state_from_numpy, state_to_numpy

FIELDS = ("image", "visibility_map", "energy_image")


def _assert_results_equal(got, want):
    for field in FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        if b is None:
            assert a is None, field
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)


# ------------------------------------------------------------ seam DP --

B, H, W = 4, 24, 256
WIDTHS = np.array([W, 200, 131, 17], np.int32)
WINDOWS = {
    "mixed widths, lo=0": (WIDTHS, np.zeros(B, np.int32)),
    "mixed widths, lo>0": (WIDTHS, np.array([0, 37, 125, 239], np.int32)),
    "one shared int window": (200, 13),
}


def _energies(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random((B, H, W), dtype=np.float32)
    return (rng.integers(0, 4, (B, H, W)) / 4).astype(np.float32)


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("kind", ["random", "quantized"])
@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
def test_find_seams_equals_pallas_vec(tie, kind, window):
    E = _energies(kind, 11 if kind == "random" else 12)
    width, lo = WINDOWS[window]
    w_b = np.broadcast_to(np.asarray(width, np.int32), (B,))
    lo_b = np.broadcast_to(np.asarray(lo, np.int32), (B,))
    want = np.asarray(find_seams_vec(jnp.asarray(E), jnp.asarray(w_b),
                                     jnp.asarray(lo_b), interpret=True,
                                     tie=tie))
    as_arg = (lambda v: torch.from_numpy(v) if isinstance(v, np.ndarray)
              else v)
    kernels.reset_launches()
    got = find_seams(torch.from_numpy(E), as_arg(width), as_arg(lo), tie=tie)
    assert got.dtype == torch.int32 and got.shape == (B, H)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() >= lo_b[:, None]).all()
    assert (got.numpy() < (lo_b + w_b)[:, None]).all()
    assert sum(kernels.launch_counts().values()) == 0
    for b in np.flatnonzero(lo_b == 0):  # the single-image DP agrees
        np.testing.assert_array_equal(
            find_seam(torch.from_numpy(E[b]), int(w_b[b]), tie=tie).numpy(),
            want[b])


def test_find_seams_rejects_bad_windows():
    E = torch.from_numpy(_energies("random", 0))
    with pytest.raises(ValueError, match="window"):
        find_seams(E, torch.tensor([W, W, W, 0], dtype=torch.int32))
    with pytest.raises(ValueError, match="window"):
        find_seams(E, 200, torch.tensor([0, 0, 57, 0], dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        find_seams(E, torch.full((3,), 5, dtype=torch.int32))
    with pytest.raises(ValueError):
        find_seams(E[0], W)


@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
def test_batched_rigidity_dp_equals_each_image(tie):
    E = torch.from_numpy((np.random.default_rng(9).integers(0, 5, (3, 30, 41))
                          / 4).astype(np.float32))
    got = tdp.find_seam(E, 2, 0.5, tie)
    for b in range(3):
        np.testing.assert_array_equal(got[b].numpy(),
                                      tdp.find_seam(E[b], 2, 0.5, tie).numpy())


# ------------------------------------- batched energy, apply, strip --

def _lumas(seed=0, shape=(3, 24, 40)):
    return torch.from_numpy(
        np.random.default_rng(seed).random(shape, dtype=np.float32))


@pytest.mark.parametrize("center", ["carve", "preview"])
@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_batched_energy_equals_each_image(n, center):
    lumas = _lumas(n)
    got = dct_energy(lumas, n, 0.3, 0.7, center=center)
    assert got.shape == lumas.shape and got.dtype == torch.float32
    for b in range(lumas.shape[0]):
        np.testing.assert_array_equal(
            got[b].numpy(),
            dct_energy(lumas[b], n, 0.3, 0.7, center=center).numpy())


@pytest.mark.parametrize("shrunk", [False, True])
def test_batched_apply_equals_each_image(shrunk):
    rng = np.random.default_rng(3)
    nb, h, w = 3, 16, 48
    width = w - 5 if shrunk else w
    luma = torch.from_numpy(rng.random((nb, h, w), dtype=np.float32))
    origcol = torch.from_numpy(rng.integers(0, 4 * w, (nb, h, w))
                               .astype(np.int32))
    energy = torch.from_numpy(rng.random((nb, h, w), dtype=np.float32))
    seam = torch.from_numpy(np.stack([
        (np.cumsum(rng.integers(-1, 2, h)) + 20) % (width - 2) + 1,
        np.minimum(np.arange(h), 2),          # the left border
        np.full(h, width - 1),                # the last live column
    ]).astype(np.int32))
    got = apply_seam(luma, origcol, energy, seam, width)
    for b in range(nb):
        want = apply_seam(luma[b], origcol[b], energy[b], seam[b], width)
        for part, g, w_ in zip(("luma", "origcol", "energy"), got, want):
            np.testing.assert_array_equal(g[b].numpy(), w_.numpy(),
                                          err_msg=part)


@pytest.mark.parametrize("n,delta_x", [(2, 1), (4, 1), (8, 1), (16, 1),
                                       (8, 2)])
def test_batched_strip_equals_each_image(n, delta_x):
    lumas = _lumas(n + delta_x, (3, 32, 64))
    E = dct_energy(lumas, n, 0.3, 0.8)
    if delta_x == 1:
        seam = find_seams(E, 64)
    else:
        seam = tdp.find_seam(E, delta_x, 0.0).to(torch.int32)
    luma, _, E = apply_seam(lumas, torch.zeros_like(lumas, dtype=torch.int32),
                            E, seam, 64)
    got = strip_update(luma, E.clone(), seam, n, 0.3, 0.8, delta_x=delta_x)
    full = dct_energy(luma, n, 0.3, 0.8)
    for b in range(3):
        want = strip_update(luma[b], E[b].clone(), seam[b], n, 0.3, 0.8,
                            delta_x=delta_x)
        np.testing.assert_array_equal(got[b].numpy(), want.numpy())
        np.testing.assert_array_equal(got[b, :, :63].numpy(),
                                      full[b, :, :63].numpy())


def test_stack_luma_and_per_image_normalization():
    rng = np.random.default_rng(4)
    gray = torch.from_numpy(rng.integers(0, 256, (3, 8, 5), dtype=np.uint8))
    # a (B, H, W) gray stack is B planes, not one (H, W, C=5) image
    np.testing.assert_array_equal(to_luma(gray, stack=True).numpy(),
                                  torch.stack([to_luma(g) for g in gray])
                                  .numpy())
    rgb = torch.from_numpy(rng.integers(0, 256, (3, 8, 5, 3), dtype=np.uint8))
    np.testing.assert_array_equal(to_luma(rgb, stack=True).numpy(),
                                  torch.stack([to_luma(x) for x in rgb])
                                  .numpy())
    e = torch.from_numpy(rng.random((3, 8, 5), dtype=np.float32))
    e[1] *= 100
    np.testing.assert_array_equal(
        normalize_to_u8(e).numpy(),
        torch.stack([normalize_to_u8(x) for x in e]).numpy())


# ---------------------------------------------------- the batch route --

ROUTE_CASES = {
    "removal": dict(seams=-5, output_seams=True),
    "enlargement": dict(seams=4, output_seams=True),
    "tie rightmost": dict(seams=-5, tie="rightmost", output_seams=True),
    "resize_canvas=False": dict(seams=-4, resize_canvas=False,
                                output_seams=True),
    "resize_canvas=False enlarged": dict(seams=3, resize_canvas=False),
    "vertically": dict(seams=-4, vertically=True, output_seams=True),
    "output_energy": dict(seams=-3, output_energy=True, output_seams=True),
    "gray stack": dict(seams=-5, gray=True, output_seams=True),
    "delta_x=2 rigidity": dict(seams=-4, delta_x=2, rigidity=0.5,
                               output_seams=True),
    "B=1": dict(seams=-5, B=1, output_seams=True),
    "B=16": dict(seams=-3, B=16, output_seams=True),
    "strip_update=False": dict(seams=-4, strip_update=False,
                               output_seams=True),
    # JAX returns no energies here (ROADMAP Queue 3, first defect): the
    # image and the vmap are compared, the energies below
    "zero seams": dict(seams=0, output_energy=True, output_seams=True),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_batch_route_equals_jax(case, make_image):
    kw = dict(ROUTE_CASES[case])
    seams = kw.pop("seams")
    nb = kw.pop("B", 3)
    gray = kw.pop("gray", False)
    imgs = np.stack([make_image(16, 24, c=None if gray else 3)
                     for _ in range(nb)])
    want = japi.carve(imgs, seams, parallel="batch", **kw)
    kernels.reset_launches()
    got = tapi.carve(imgs, seams, parallel="batch", device="cpu", **kw)
    assert sum(kernels.launch_counts().values()) == 0
    if case == "zero seams":
        assert want.energy_image is None
        single = np.stack([Carver(im, device="cpu").energy_image()
                           for im in imgs])
        np.testing.assert_array_equal(got.energy_image, single)
        want.energy_image = got.energy_image
    _assert_results_equal(got, want)
    assert got.image.shape[0] == nb


@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
@pytest.mark.parametrize("kind", ["random", "quantized"])
def test_batch_vmaps_equal_native_f32_at_n2(kind, tie):
    imgs = np.random.default_rng(21).integers(0, 256, (3, 24, 40),
                                              dtype=np.uint8)
    if kind == "quantized":
        imgs = (imgs // 64) * 64
    _, vmaps = tmesh.carve_batch(imgs, 8, blocksize=2, edges=0.3,
                                 textures=0.7, tie=tie, reconstruct=False,
                                 devices=["cpu"])
    for b in range(3):
        luma = imgs[b].astype(np.float32) / np.float32(255.0)
        np.testing.assert_array_equal(
            vmaps[b].numpy(), carve_native_f32(luma, 8, 2, 0.3, 0.7, tie=tie))


@pytest.mark.parametrize("case", [
    dict(seams=-6, output_seams=True, output_energy=True),
    dict(seams=5, output_seams=True, blocksize=4),
    dict(seams=-4, vertically=True, output_seams=True, output_energy=True),
])
def test_batch_images_equal_single_image_carve(case, make_image):
    case = dict(case)
    seams = case.pop("seams")
    imgs = np.stack([make_image(20, 32, c=3) for _ in range(4)])
    res = tapi.carve(imgs, seams, parallel="batch", device="cpu", **case)
    for b in range(len(imgs)):
        single = tapi.carve(imgs[b], seams, device="cpu", **case)
        for field in FIELDS:
            a, s = getattr(res, field), getattr(single, field)
            if s is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a[b], s, err_msg=field)


@pytest.mark.parametrize("reconstruct", [True, False])
def test_device_split_equals_one_device(reconstruct, make_image):
    imgs = np.stack([make_image(16, 24, c=3) for _ in range(5)])
    out3, vm3 = tmesh.carve_batch(imgs, 3, devices=["cpu"] * 3,
                                  reconstruct=reconstruct)
    out1, vm1 = tmesh.carve_batch(imgs, 3, devices=["cpu"],
                                  reconstruct=reconstruct)
    np.testing.assert_array_equal(vm3.numpy(), vm1.numpy())
    if reconstruct:
        assert out3.shape == (5, 16, 21, 3)
        np.testing.assert_array_equal(out3.numpy(), out1.numpy())
    else:
        assert out3 is None and out1 is None
    # more devices than images: the empty chunks are skipped
    _, vm7 = tmesh.carve_batch(imgs[:2], 3, devices=["cpu"] * 7,
                               reconstruct=False)
    np.testing.assert_array_equal(vm7.numpy(), vm1[:2].numpy())


def test_batch_carve_states_equals_jax(make_image):
    imgs = np.stack([make_image(16, 32, c=3) for _ in range(3)])
    want = jmesh.batch_carve_states(jnp.asarray(imgs), 4, 8, 0.0, 1.0,
                                    use_pallas=False)
    got = tmesh.batch_carve_states(torch.from_numpy(imgs), 4, 8, 0.0, 1.0)
    assert got.width == 28 and (np.asarray(want.width) == 28).all()
    # (the lumas are not compared: JAX's jitted luma contracts its
    # multiply-adds and parts from the port's by an ulp, ROADMAP Queue 3)
    np.testing.assert_array_equal(got.vmap.numpy(), np.asarray(want.vmap))
    np.testing.assert_array_equal(got.origcol[..., :28].numpy(),
                                  np.asarray(want.origcol)[..., :28])


def test_auto_routes_a_stack_to_batch_and_an_image_to_none(make_image):
    imgs = np.stack([make_image(16, 24, c=3) for _ in range(3)])
    batch = tapi.carve(imgs, -3, parallel="batch", output_seams=True,
                       device="cpu")
    auto = tapi.carve(imgs, -3, parallel="auto", output_seams=True,
                      device="cpu")
    _assert_results_equal(auto, batch)
    _assert_results_equal(
        tapi.carve(imgs[1], -3, parallel="auto", device="cpu"),
        tapi.carve(imgs[1], -3, device="cpu"))


def test_batch_route_rejects_bad_stacks():
    imgs = np.zeros((2, 16, 24, 3), np.uint8)
    with pytest.raises(ValueError, match="stack"):
        tapi.carve(imgs[0, ..., 0], -3, parallel="batch", device="cpu")
    with pytest.raises(ValueError, match="stack"):
        tapi.carve(imgs[None], -3, parallel="batch", device="cpu")
    with pytest.raises(ValueError, match="24 wide"):
        tapi.carve(imgs, -24, parallel="batch", device="cpu")
    with pytest.raises(ValueError, match="stack"):
        tmesh.carve_batch(imgs[:0], 3, devices=["cpu"])
    # pluggable energies are ported: the energy now carves the stack
    out, vm = tmesh.carve_batch(imgs, 3, energy="grad_xabs", devices=["cpu"])
    assert out.shape == (2, 16, 21, 3)
    assert ((vm > 0).sum(dim=2) == 3).all()
    with pytest.raises(ValueError, match="unknown builtin energy"):
        tmesh.carve_batch(imgs, 3, energy="grad_bogus", devices=["cpu"])
    # the spatial route (ported) carves one image, not a stack
    with pytest.raises(ValueError, match=r"\(H, W\) or \(H, W, C\)"):
        tapi.carve(imgs, -3, parallel="spatial", device="cpu")


def test_carver_rejects_the_batch_route():
    with pytest.raises(ValueError, match="image stacks"):
        Carver(np.zeros((16, 24, 3), np.uint8), parallel="batch",
               device="cpu")


def test_batched_state_from_jax_continues_in_port(make_image):
    """A batch carve started in JAX (`batch_carve_states`, k seams) goes on
    in the port to n seams and ends where JAX's n-seam carve ends."""
    imgs = np.stack([make_image(16, 32, c=3) for _ in range(3)])
    k, n = 3, 6
    mid = jmesh.batch_carve_states(jnp.asarray(imgs), k, 8, 0.0, 1.0,
                                   use_pallas=False)
    end = jmesh.batch_carve_states(jnp.asarray(imgs), n, 8, 0.0, 1.0,
                                   use_pallas=False)
    arrays = {name: np.asarray(v) for name, v in mid._asdict().items()}
    state = state_from_numpy(arrays, device="cpu")
    assert state.width == 32 - k and state.luma.shape == (3, 16, 32)
    back = state_to_numpy(state)
    for name, v in arrays.items():
        assert back[name].dtype == v.dtype and back[name].shape == v.shape
        np.testing.assert_array_equal(back[name], v)
    for i in range(k, n):
        state = tcarve.carve_seams(state, i, 1, 8, 0.0, 1.0,
                                   strip_update=True)
    assert state.width == 32 - n
    np.testing.assert_array_equal(state.vmap.numpy(), np.asarray(end.vmap))
    np.testing.assert_array_equal(state.luma.numpy(), np.asarray(end.luma))


def test_state_from_numpy_rejects_unequal_widths():
    arrays = state_to_numpy(tcarve.make_state(torch.zeros((2, 4, 6))))
    assert arrays["width"].shape == (2,)
    arrays["width"] = np.array([6, 5], np.int32)
    with pytest.raises(ValueError, match="one width"):
        state_from_numpy(arrays, device="cpu")
