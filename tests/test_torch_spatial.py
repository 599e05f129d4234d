"""The port's spatial route (`dct_carver_tpu_torch/parallel/spatial.py`) on
`devices=["cpu"] * 8` against the JAX package's spatial carve on the
8-device CPU mesh of conftest.py, and against the single-device routes.

Vmaps, images and widths are compared bitwise.  JAX spatial carves compile
for seconds each, so only the cases that need JAX run it; the others are
held against the port's own single-device carve and the native f32 carver
(`utils/native.py::carve_native_f32`), which the single-device carve equals
(tests/test_torch_carve.py).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dct_carver_tpu.oracle import reference as oracle
from dct_carver_tpu.parallel import spatial as jsp
from dct_carver_tpu.parallel.mesh import make_mesh as jax_mesh
from dct_carver_tpu.utils.native import carve_native_f32
from dct_carver_tpu_torch import api as tapi
from dct_carver_tpu_torch.models.carver import Carver
from dct_carver_tpu_torch.ops import carve as tcarve
from dct_carver_tpu_torch.parallel import spatial as tsp
from dct_carver_tpu_torch.parallel.mesh import make_mesh
from dct_carver_tpu_torch.parallel.shards import ShardMesh
from dct_carver_tpu_torch.utils.state import (spatial_state_from_numpy,
                                              spatial_state_to_numpy)

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8
    return jax_mesh(axis_name="x")


def _luma(h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    return np.asarray(oracle.luma_bt709(img), np.float32), img


def _same(port, jax_res, image=False):
    np.testing.assert_array_equal(port.vmap.numpy(), np.asarray(jax_res.vmap))
    assert port.width == int(jax_res.width)
    if image:
        np.testing.assert_array_equal(port.image.numpy(),
                                      np.asarray(jax_res.image))


# ---------------------------------------------------------- against JAX ---

@pytest.mark.parametrize("case", [
    # blocksize 4, a width the mesh does not divide, the RGB image carried
    dict(h=16, w=61, n=3, kw=dict(blocksize=4, edges=0.3, textures=0.8),
         image=True),
    # the generalized DP (plain scan and walk) with strip updates
    dict(h=24, w=128, n=4, kw=dict(delta_x=2, rigidity=0.5)),
    dict(h=24, w=64, n=4, kw=dict(tie="rightmost")),
    dict(h=24, w=64, n=4, kw=dict(energy="grad_norm")),
    # K = 8 on 8-column shards: Hh = 16 needs the two-hop halo relay, so
    # the DP takes the message form (#16)
    dict(h=24, w=64, n=4, kw=dict(frontier_block=8)),
], ids=["bs4-w61-image", "dx2-rigidity", "rightmost", "grad_norm",
        "multi-hop"])
def test_spatial_carve_equals_jax(mesh8, case):
    seed = case["w"] + case["n"]
    luma, img = _luma(case["h"], case["w"], seed=seed)
    image = img if case.get("image") else None
    want = jsp.spatial_carve_n_seams(luma, case["n"], mesh=mesh8,
                                     image=image, **case["kw"])
    got = tsp.spatial_carve_n_seams(luma, case["n"], devices=CPU8,
                                    image=image, **case["kw"])
    _same(got, want, image=image is not None)


@pytest.mark.parametrize("case", [
    # an odd seam count in odd chunks: the step ends on either buffer set
    # and a chunk boundary falls after each parity
    dict(h=16, w=64, n=5, chunk=3, image=True),
    dict(h=24, w=64, n=5, chunk=2, kw=dict(energy="grad_norm")),
    dict(h=16, w=61, n=7, chunk=1, kw=dict(tie="rightmost", blocksize=4)),
], ids=["chunk3-image", "chunk2-grad_norm", "chunk1-rightmost"])
def test_chunked_static_steps_equal_jax(mesh8, case):
    """The seam step over static buffers (two plane sets that swap every
    seam, the width on the device, a record a chunk), run eagerly on the
    CPU mesh, equals JAX's uninterrupted spatial carve."""
    luma, img = _luma(case["h"], case["w"], seed=case["n"] + case["chunk"])
    image = img if case.get("image") else None
    kw = case.get("kw", {})
    want = jsp.spatial_carve_n_seams(luma, case["n"], mesh=mesh8,
                                     image=image, **kw)
    got = tsp.spatial_carve_n_seams(luma, case["n"], devices=CPU8,
                                    image=image, chunk=case["chunk"], **kw)
    _same(got, want, image=image is not None)
    assert got.capture_seconds == 0.0  # no graph on the CPU


def test_chunked_enlarge_equals_jax(mesh8):
    luma, img = _luma(16, 61, seed=37)
    want = jsp.spatial_enlarge_n_seams(luma, 5, img, mesh=mesh8)
    got = tsp.spatial_enlarge_n_seams(luma, 5, img, devices=CPU8, chunk=3)
    _same(got, want, image=True)


def test_resumed_checkpoint_equals_jax(mesh8, tmp_path):
    """A checkpointed carve in chunks of 3, resumed in chunks of 1 on a
    fresh set of buffers, equals JAX's uninterrupted carve."""
    luma, img = _luma(16, 64, seed=17)
    n = 7
    want = jsp.spatial_carve_n_seams(luma, n, mesh=mesh8, image=img)
    ck = str(tmp_path / "ck")
    tsp.spatial_carve_n_seams(luma, n, devices=CPU8, image=img, chunk=3,
                              checkpoint_dir=ck)
    with open(os.path.join(ck, "meta.json")) as f:
        meta = json.load(f)
    meta["seams_done"] = 3
    with open(os.path.join(ck, "meta.json"), "w") as f:
        json.dump(meta, f)
    # the newest committed step (6 seams) is the one resumed
    got = tsp.spatial_carve_n_seams(luma, n, devices=CPU8, image=img,
                                    resume_from=ck, chunk=1)
    _same(got, want, image=True)


def test_static_steps_swap_two_buffer_sets():
    """Seams alternate between the two plane sets, across chunks, and the
    carve's buffers are those sets; on the CPU every step runs eagerly."""
    luma, img = _luma(16, 64, seed=23)
    st, mesh = tsp.spatial_make_state(luma, devices=CPU8, image=img)
    p = tsp._params(64, 16, dead_max=5)
    steps = tsp._SeamSteps(mesh, st, p)
    assert steps.graph_cards is None
    assert steps.sets[0].luma is st.luma
    mid = steps.carve(st, 0, 3)
    assert mid.luma is steps.sets[1].luma and mid.image is steps.sets[1].image
    assert mid.width == 61
    end = steps.carve(mid, 3, 2)
    assert end.luma is steps.sets[1].luma and end.energy is \
        steps.sets[1].energy
    assert [int(w) for w in steps.width] == [59]
    whole = tsp.spatial_carve_n_seams(luma, 5, devices=CPU8, image=img)
    np.testing.assert_array_equal(mesh.join(end.vmap).numpy(),
                                  whole.vmap.numpy())
    np.testing.assert_array_equal(mesh.join(end.image).numpy(),
                                  whole.image.numpy())
    plain = tsp._SeamSteps(mesh, st, tsp._params(64, 16, use_pallas=False))
    assert plain.graph_cards is None


def test_spatial_enlarge_equals_jax(mesh8):
    luma, img = _luma(16, 61, seed=31)
    gray = img[..., 0]
    want = jsp.spatial_enlarge_n_seams(luma, 5, gray, mesh=mesh8)
    got = tsp.spatial_enlarge_n_seams(luma, 5, gray, devices=CPU8)
    _same(got, want, image=True)
    assert got.image.shape == (16, 66)


def test_jax_state_finishes_in_the_port(mesh8):
    """A JAX SpatialCarveState after m seams, carried across as numpy,
    finishes in the port with the vmap of JAX's uninterrupted carve."""
    luma, _ = _luma(16, 64, seed=13)
    m, n = 3, 6
    state, _ = jsp.spatial_make_state(luma, mesh=mesh8)
    mid = jsp._spatial_chunk_jit(state, jnp.int32(0), m, 8, 0.0, 1.0, mesh8,
                                 "x", jsp.FRONTIER_BLOCK, True, False, 1,
                                 0.0, False, None, "leftmost", n)
    whole = jsp.spatial_carve_n_seams(luma, n, mesh=mesh8, chunk=m)
    arrays = {k: np.asarray(v) for k, v in mid._asdict().items()}
    st, mesh = spatial_state_from_numpy(arrays, CPU8)
    back = spatial_state_to_numpy(st, mesh)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
    st = tsp.spatial_carve_seams(st, mesh, m, n - m, image_width=64)
    np.testing.assert_array_equal(mesh.join(st.vmap).numpy(),
                                  np.asarray(whole.vmap))
    assert st.width == int(whole.width) == 64 - n


# --------------------------------------------- against the port's routes --

@pytest.mark.parametrize("blocksize", [2, 16])
def test_spatial_equals_native_and_single_device(blocksize):
    luma, _ = _luma(24, 64, seed=blocksize)
    n = 6
    single = tcarve.carve_n_seams(torch.from_numpy(luma), n, blocksize, 0.2,
                                  0.9)
    got = tsp.spatial_carve_n_seams(luma, n, blocksize=blocksize, edges=0.2,
                                    textures=0.9, devices=CPU8)
    np.testing.assert_array_equal(got.vmap.numpy(), single.vmap.numpy())
    np.testing.assert_array_equal(
        got.vmap.numpy(), carve_native_f32(luma, n, blocksize, 0.2, 0.9))


@pytest.mark.parametrize("w,K,devices", [
    (256, 24, CPU8),          # single-hop halos, the parts form (#17)
    (2048, 32, CPU8),         # 256-column shards, K = 32
    (120, 7, ["cpu"] * 3),    # remainder blocks, K odd
    # alternating "cpu" / "cpu:0" entries make 8 one-shard stacks: every
    # exchange crosses stacks
    (64, 96, ["cpu", "cpu:0"] * 4),
])
def test_kernel_structure_equals_plain_route(w, K, devices):
    """use_pallas=True takes the kernels' structure (parts / message block
    DP, segment walk, fused apply with the right-edge window), here through
    their plain versions; use_pallas=False takes JAX's plain scan and
    remove / edge-fill.  Both equal the single-device carve."""
    luma, img = _luma(48, w, seed=w + K)
    n = 5
    single = tcarve.carve_n_seams(torch.from_numpy(luma), n, 8, 0.0, 1.0)
    ref = tcarve.reconstruct_removed(torch.from_numpy(img), single.vmap, n)
    for use_pallas in (True, False):
        got = tsp.spatial_carve_n_seams(luma, n, devices=devices,
                                        frontier_block=K, image=img,
                                        use_pallas=use_pallas)
        np.testing.assert_array_equal(got.vmap.numpy(), single.vmap.numpy())
        np.testing.assert_array_equal(got.image[:, :w - n].numpy(),
                                      ref.numpy())


def test_spatial_enlarge_rgb_equals_reconstruct_enlarged():
    luma, img = _luma(16, 64, seed=7)
    got = tsp.spatial_enlarge_n_seams(luma, 5, img, devices=CPU8)
    single = tcarve.carve_n_seams(torch.from_numpy(luma), 5, 8, 0.0, 1.0)
    want = tcarve.reconstruct_enlarged(torch.from_numpy(img), single.vmap, 5)
    np.testing.assert_array_equal(got.image.numpy(), want.numpy())
    assert got.width == 69


@pytest.mark.parametrize("hwkp", [(32, 512, 8, False), (48, 1024, 16, False),
                                  (32, 2048, 8, True),
                                  # a remainder block, the fused removal
                                  (40, 1024, 16, True)])
def test_exchanges_equal_design(hwkp):
    """The exchanges of one seam step, counted by the exchange layer, equal
    the design's `collectives_per_seam`, as the JAX package's compiled HLO
    does (tests/test_spatial.py::test_measured_collectives_match_design)."""
    H, W, K, fused = hwkp
    m = tsp.measure_collectives_per_seam(H, W, CPU8, frontier_block=K,
                                         use_pallas=fused)
    assert m["total"] == m["designed"] == tsp.collectives_per_seam(
        H, K, fused_apply=fused)
    assert m["designed"] == jsp.collectives_per_seam(H, K, fused_apply=fused)


# ------------------------------------------------ checkpoints, progress ---

def test_chunked_resume_equals_uninterrupted(tmp_path):
    luma, img = _luma(16, 64, seed=11)
    n = 5
    ref = tsp.spatial_carve_n_seams(luma, n, devices=CPU8, image=img)
    ck = str(tmp_path / "ck")
    got = tsp.spatial_carve_n_seams(luma, n, devices=CPU8, image=img,
                                    chunk=2, checkpoint_dir=ck)
    np.testing.assert_array_equal(got.vmap.numpy(), ref.vmap.numpy())
    # the newest committed step is the progress counter, even when
    # meta.json is stale; older steps are pruned
    assert sorted(os.listdir(ck)) == ["meta.json", "state-00000004"]
    with open(os.path.join(ck, "meta.json")) as f:
        meta = json.load(f)
    meta["seams_done"] = 2
    with open(os.path.join(ck, "meta.json"), "w") as f:
        json.dump(meta, f)
    # resume on another mesh size
    res = tsp.spatial_carve_n_seams(luma, n, devices=["cpu"] * 4, image=img,
                                    resume_from=ck)
    np.testing.assert_array_equal(res.vmap.numpy(), ref.vmap.numpy())
    np.testing.assert_array_equal(res.image.numpy(), ref.image.numpy())
    assert res.width == 64 - n


def test_resume_mismatches_raise(tmp_path):
    luma, img = _luma(16, 64, seed=41)
    ck = str(tmp_path / "ck")
    tsp.spatial_carve_n_seams(luma, 4, devices=CPU8, chunk=2,
                              checkpoint_dir=ck, edges=0.3, textures=0.7)
    with pytest.raises(ValueError, match="parameter"):
        tsp.spatial_carve_n_seams(luma, 4, devices=CPU8, resume_from=ck,
                                  edges=0.9, textures=0.1)
    with pytest.raises(ValueError, match="with_image"):
        tsp.spatial_carve_n_seams(luma, 4, devices=CPU8, resume_from=ck,
                                  edges=0.3, textures=0.7, image=img)
    with pytest.raises(ValueError, match="seams"):
        tsp.spatial_carve_n_seams(luma, 6, devices=CPU8, resume_from=ck,
                                  edges=0.3, textures=0.7)


def test_progress_hooks():
    calls = []

    class Rec:
        def init(self, msg):
            calls.append(("init", msg))

        def update(self, f):
            calls.append(("update", f))

        def end(self):
            calls.append(("end", None))

    luma, _ = _luma(16, 64, seed=43)
    tsp.spatial_carve_n_seams(luma, 5, devices=CPU8, chunk=2, progress=Rec())
    assert calls[0][0] == "init" and calls[-1] == ("end", None)
    fracs = [f for k, f in calls if k == "update"]
    assert fracs == [0.4, 0.8, 1.0]


# ------------------------------------------------------ the entry points --

@pytest.mark.parametrize("case", [
    dict(seams=-4, output_seams=True, output_energy=True),
    dict(seams=3, output_seams=True),
    dict(seams=-3, vertically=True, output_seams=True, energy="grad_sumabs"),
    dict(seams=-4, resize_canvas=False, tie="rightmost"),
])
def test_api_carve_spatial_equals_single_device(case):
    case = dict(case)
    seams = case.pop("seams")
    _, img = _luma(24, 40, seed=abs(seams))
    got = tapi.carve(img, seams, parallel="spatial", devices=["cpu"] * 4,
                     **case)
    want = tapi.carve(img, seams, device="cpu", **case)
    for field in ("image", "visibility_map", "energy_image"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(a, b)


def test_carver_routes_and_cli(tmp_path):
    from dct_carver_tpu_torch import cli
    from dct_carver_tpu_torch.utils.image import load_image, save_image

    _, img = _luma(20, 48, seed=3)
    # "auto" over a mesh of more than one device takes the spatial route
    auto = Carver(img, parallel="auto", devices=["cpu"] * 2,
                  output_seams=True)
    assert auto._resolved_parallel() == "spatial"
    assert Carver(img, parallel="auto", device="cpu")._resolved_parallel() \
        == "none"
    want = Carver(img, device="cpu", output_seams=True).resize(44, 20)
    got = auto.resize(44, 20)
    np.testing.assert_array_equal(got.image, want.image)
    np.testing.assert_array_equal(got.visibility_map, want.visibility_map)

    inp = str(tmp_path / "in.ppm")
    save_image(inp, img)
    outs = {}
    for tag, route in (("none", ["--parallel", "none"]),
                       ("spatial", ["--parallel", "spatial"]),
                       ("flag", ["--spatial"])):
        outs[tag] = str(tmp_path / f"{tag}.ppm")
        assert cli.main(["carve", inp, outs[tag], "--seams", "-4",
                         "--device", "cpu", *route]) == 0
    for tag in ("spatial", "flag"):
        np.testing.assert_array_equal(load_image(outs[tag]),
                                      load_image(outs["none"]))


def test_one_placement_on_every_route(monkeypatch):
    """`devices` places the batch route as it does the spatial one, a
    `device` that is not the mesh's first raises, and with no `devices` the
    mesh follows `device`."""
    from dct_carver_tpu_torch.utils.placement import default_mesh
    from dct_carver_tpu_torch.parallel import mesh as tmesh

    _, img = _luma(12, 20, seed=5)
    imgs = np.stack([img, img[::-1]])
    seen = []
    carve_batch = tmesh.carve_batch

    def spy(*args, devices=None, **kw):
        seen.append(devices)
        return carve_batch(*args, devices=devices, **kw)

    monkeypatch.setattr(tmesh, "carve_batch", spy)
    got = tapi.carve(imgs, -3, parallel="batch", devices=["cpu"] * 2)
    assert seen == [[torch.device("cpu")] * 2]
    np.testing.assert_array_equal(
        got.image, tapi.carve(imgs, -3, parallel="batch", device="cpu").image)
    for call in (lambda: tapi.carve(imgs, -3, parallel="batch",
                                    device="meta", devices=["cpu"] * 2),
                 lambda: Carver(img, device="meta", devices=["cpu"] * 2)):
        with pytest.raises(ValueError, match="first device"):
            call()
    assert Carver(img, device="cpu", devices=["cpu"] * 2).device \
        == torch.device("cpu")
    assert default_mesh(torch.device("cuda", 1)) == [torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert default_mesh(torch.device("cuda")) == [torch.device("cuda", 0),
                                                 torch.device("cuda", 1)]


def test_no_card_raises_unless_the_cpu_is_asked_for(monkeypatch, tmp_path):
    """With no card visible the entry points raise; they never carry on on
    the CPU unless asked to."""
    from dct_carver_tpu_torch import cli
    from dct_carver_tpu_torch.parallel.mesh import carve_batch
    from dct_carver_tpu_torch.utils.image import save_image

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    _, img = _luma(8, 16)
    inp = str(tmp_path / "in.ppm")
    save_image(inp, img)
    for call in (lambda: tapi.carve(img, -2),
                 lambda: tapi.carve(img, -2, device="cuda"),
                 lambda: Carver(img),
                 lambda: carve_batch(img[None], 1),
                 lambda: tsp.spatial_carve_n_seams(img[..., 0] / 255.0, 1),
                 lambda: make_mesh(),
                 lambda: cli.main(["carve", inp, inp, "--seams", "-2"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tapi.carve(img, -2, device="cpu").image.shape == (8, 14, 3)


def test_shard_mesh_layout():
    mesh = ShardMesh(["cpu", "cpu", "cpu:0", "cpu"], 16)
    assert [(s.first, s.count) for s in mesh.stacks] == [(0, 2), (2, 1),
                                                        (3, 1)]
    x = torch.arange(3 * 16).reshape(3, 16)
    parts = mesh.split(x)
    assert [tuple(p.shape) for p in parts] == [(2, 3, 4), (1, 3, 4),
                                              (1, 3, 4)]
    assert torch.equal(mesh.join(parts), x)
    with pytest.raises(ValueError, match="divisible"):
        ShardMesh(["cpu"] * 3, 16)
