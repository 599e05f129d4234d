"""The port's pluggable energies (`dct_carver_tpu_torch/ops/energy_fn.py`)
and the plugged-energy strip path on the CPU.

Tolerances: the builtins are elementwise, every op rounded on its own, so
they are held bit for bit against eager JAX (op by op, nothing contracted)
and the NumPy oracle.  Jitted JAX may contract `dx*dx + dy*dy` into an FMA
(ROADMAP Queue 3), so whole carves with `grad_norm` are held against the
oracle DP and the others against JAX.  A custom energy's block function
reduces its window; JAX and torch may sum in another order, so custom
energies are held against JAX within rtol=1e-5, atol=1e-6 (the JAX
package's own tolerance for its variance check, tests/test_energy_fn.py),
and strip against full by their vmaps.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_carver_tpu import api as japi
from dct_carver_tpu.models.carver import Carver as JCarver
from dct_carver_tpu.ops import carve as jcarve
from dct_carver_tpu.ops import dct as jdct
from dct_carver_tpu.ops import energy_fn as jfn
from dct_carver_tpu.oracle import reference as oracle
from dct_carver_tpu.parallel import mesh as jmesh
from dct_carver_tpu.utils import checkpoint as jckpt
from dct_carver_tpu.utils.config import CarverConfig as JConfig
from dct_carver_tpu_torch import api as tapi
from dct_carver_tpu_torch import kernels
from dct_carver_tpu_torch.kernels.strip_kernel import (band_energy,
                                                       strip_gather,
                                                       strip_scatter)
from dct_carver_tpu_torch.models.carver import Carver
from dct_carver_tpu_torch.ops import carve as tcarve
from dct_carver_tpu_torch.ops import strip as tstrip
from dct_carver_tpu_torch.ops.dct import energy_from_bands, rows_to_bands
from dct_carver_tpu_torch.ops.energy_fn import (
    BUILTIN_ENERGIES, ENERGY_NULL, GRAD_NORM, GRAD_SUMABS, GRAD_XABS,
    EnergyFunction, builtin_energy, custom_energy, resolve_energy)
from dct_carver_tpu_torch.parallel import mesh as tmesh
from dct_carver_tpu_torch.utils import checkpoint as tckpt
from dct_carver_tpu_torch.utils.config import CarverConfig

BUILTINS = ["grad_xabs", "grad_sumabs", "grad_norm", "null"]
# jitted JAX computes these bit for bit like the port (no multiply-add)
JAX_EXACT = ["grad_xabs", "grad_sumabs"]
CUSTOM_TOL = dict(rtol=1e-5, atol=1e-6)


def _rand_luma(h, w, seed=0):
    return np.random.default_rng(seed).random((h, w), dtype=np.float32)


def _custom(kind):
    """The same block function in torch (port) and jax.numpy (JAX)."""
    if kind == "variance":
        return (custom_energy(2, lambda w: torch.var(w, correction=0),
                              name="variance"),
                jfn.custom_energy(2, lambda w: jnp.var(w), name="variance"))
    return (custom_energy(2, lambda w: torch.sum(torch.abs(w))
                          - 16.0 * torch.abs(w[1, 1]), name="absdev"),
            jfn.custom_energy(2, lambda w: jnp.sum(jnp.abs(w))
                              - 16.0 * jnp.abs(w[1, 1]), name="absdev"))


# ------------------------------------------------------------ energies --

@pytest.mark.parametrize("name", BUILTINS)
def test_builtin_bands_fn_equals_eager_jax(name):
    bands = np.random.default_rng(1).random((37, 2, 29), dtype=np.float32)
    got = builtin_energy(name).bands_fn(torch.from_numpy(bands))
    want = np.asarray(jfn.builtin_energy(name).bands_fn(jnp.asarray(bands)))
    assert got.dtype == torch.float32 and got.shape == (37, 28)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", BUILTINS)
def test_builtin_energy_map_equals_oracle(name):
    luma = _rand_luma(37, 53, seed=2)
    fn = builtin_energy(name)
    got = fn.energy_map(torch.from_numpy(luma))
    np.testing.assert_array_equal(got.numpy(),
                                  oracle.gradient_energy_map(luma, name))
    # a (B, H, W) stack: each plane's own map
    stack = np.stack([luma, _rand_luma(37, 53, seed=3)])
    got = fn.energy_map(torch.from_numpy(stack))
    for b in range(2):
        np.testing.assert_array_equal(
            got[b].numpy(), oracle.gradient_energy_map(stack[b], name))


@pytest.mark.parametrize("kind", ["variance", "absdev"])
def test_custom_energy_equals_jax(kind):
    port, jax_fn = _custom(kind)
    luma = _rand_luma(24, 40, seed=4)
    got = port.energy_map(torch.from_numpy(luma)).numpy()
    want = np.asarray(jax_fn.energy_map(jnp.asarray(luma)))
    np.testing.assert_allclose(got, want, **CUSTOM_TOL)
    bands = np.random.default_rng(5).random((9, 4, 13), dtype=np.float32)
    np.testing.assert_allclose(
        port.bands_fn(torch.from_numpy(bands)).numpy(),
        np.asarray(jax_fn.bands_fn(jnp.asarray(bands))), **CUSTOM_TOL)


def test_custom_energy_window_layout():
    """Tap (r-1, r-1) is the pixel itself; tap (0, 0) reads offset
    (-(r-1), -(r-1)) with edge clamping (src/render.c:146-151)."""
    luma = _rand_luma(16, 19, seed=6)
    t = torch.from_numpy(luma)
    for radius in (1, 2, 4):
        fn = custom_energy(radius, lambda w, r=radius: w[r - 1, r - 1])
        np.testing.assert_array_equal(fn.energy_map(t).numpy(), luma)
    fn = custom_energy(2, lambda w: w[0, 0])
    want = luma[np.maximum(np.arange(16) - 1, 0)][
        :, np.maximum(np.arange(19) - 1, 0)]
    np.testing.assert_array_equal(fn.energy_map(t).numpy(), want)


def test_resolve_energy_and_config():
    assert resolve_energy(None) is None
    assert resolve_energy("dct") is None
    assert resolve_energy("grad_norm") is GRAD_NORM
    assert resolve_energy(GRAD_XABS) is GRAD_XABS
    assert sorted(BUILTIN_ENERGIES) == sorted(jfn.BUILTIN_ENERGIES)
    with pytest.raises(ValueError):
        resolve_energy("nope")
    with pytest.raises(TypeError):
        resolve_energy(42)
    with pytest.raises(ValueError):
        custom_energy(0, lambda w: w[0, 0])
    with pytest.raises(ValueError):
        resolve_energy(EnergyFunction("odd", 3, lambda b: b[:, 0, :-2]))
    cfg = CarverConfig(energy="grad_sumabs")
    assert cfg.energy_function is GRAD_SUMABS
    assert cfg.radius == 1 and CarverConfig(blocksize=16).radius == 8
    assert CarverConfig(energy=custom_energy(3, torch.sum)).radius == 3
    with pytest.raises(ValueError):
        CarverConfig(energy="bogus")


# ----------------------------------------------------- strip == full --

@pytest.mark.parametrize("name,delta_x", [(n, 1) for n in BUILTINS]
                         + [("grad_norm", 2)])
def test_strip_equals_full_for_builtins(name, delta_x):
    fn = builtin_energy(name)
    luma = torch.from_numpy(_rand_luma(48, 80, seed=7))
    kw = dict(energy_fn=fn, delta_x=delta_x)
    full = tcarve.carve_n_seams(luma, 10, 8, 0.0, 1.0, strip_update=False,
                                **kw)
    strip = tcarve.carve_n_seams(luma, 10, 8, 0.0, 1.0, **kw)
    np.testing.assert_array_equal(full.vmap.numpy(), strip.vmap.numpy())
    w = full.width
    np.testing.assert_array_equal(full.energy[:, :w].numpy(),
                                  strip.energy[:, :w].numpy())
    np.testing.assert_array_equal(
        strip.energy[:, :w].numpy(),
        oracle.gradient_energy_map(strip.luma[:, :w].numpy(), name))


@pytest.mark.parametrize("kind", ["variance", "absdev"])
def test_strip_equals_full_for_custom_energy(kind):
    fn, _ = _custom(kind)
    luma = torch.from_numpy(_rand_luma(40, 64, seed=8))
    full = tcarve.carve_n_seams(luma, 8, 8, 0.0, 1.0, strip_update=False,
                                energy_fn=fn)
    strip = tcarve.carve_n_seams(luma, 8, 8, 0.0, 1.0, energy_fn=fn)
    np.testing.assert_array_equal(full.vmap.numpy(), strip.vmap.numpy())


def test_window_of_the_energy_sizes_the_strip():
    """The strip extent and the narrow-image guard come from the energy's n,
    not from `blocksize`: a 2-wide gradient under blocksize=16 keeps its
    strip on an 11-wide image."""
    assert tstrip.strip_fits(11, 16, 1, GRAD_NORM)
    assert not tstrip.strip_fits(11, 16)
    luma = torch.from_numpy(_rand_luma(16, 11, seed=9))
    strip = tcarve.carve_n_seams(luma, 4, 16, 0.0, 1.0, energy_fn=GRAD_NORM)
    full = tcarve.carve_n_seams(luma, 4, 16, 0.0, 1.0, energy_fn=GRAD_NORM,
                                strip_update=False)
    np.testing.assert_array_equal(strip.vmap.numpy(), full.vmap.numpy())
    np.testing.assert_array_equal(strip.energy[:, :7].numpy(),
                                  full.energy[:, :7].numpy())


@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
@pytest.mark.parametrize("name", ["grad_xabs", "grad_sumabs", "grad_norm"])
def test_carve_equals_oracle_dp(name, tie):
    """Seam selection with a plugged energy equals a scalar NumPy carve
    driving the oracle DP with the oracle's energy."""
    luma = _rand_luma(32, 48, seed=10)
    n_seams = 6
    cur = luma.copy()
    H, W = cur.shape
    origcol = np.broadcast_to(np.arange(W, dtype=np.int32), (H, W)).copy()
    vmap_ref = np.zeros((H, W), np.int32)
    for k in range(1, n_seams + 1):
        seam = oracle.find_seam(oracle.gradient_energy_map(cur, name),
                                tie=tie)
        vmap_ref[np.arange(H), origcol[np.arange(H), seam]] = k
        cur = oracle._remove_seam(cur, seam)
        origcol = oracle._remove_seam(origcol, seam)
    kernels.reset_launches()
    state = tcarve.carve_n_seams(torch.from_numpy(luma), n_seams, 8, 0.0,
                                 1.0, energy_fn=builtin_energy(name),
                                 tie=tie)
    np.testing.assert_array_equal(state.vmap.numpy(), vmap_ref)
    assert sum(kernels.launch_counts().values()) == 0


# ------------------------------------- strip kernels' plain versions --

def _after_one_seam(luma, fn):
    """(compacted luma, compacted old energy, seam, first energy) after one
    seam with energy `fn`."""
    from dct_carver_tpu_torch.kernels.apply_kernel import apply_seam
    from dct_carver_tpu_torch.kernels.dp_kernel import find_seam

    t = torch.from_numpy(luma)
    E0 = fn.energy_map(t)
    seam = find_seam(E0, t.shape[1])
    l1, _, e1 = apply_seam(t, torch.zeros_like(t, dtype=torch.int32), E0,
                           seam, t.shape[1])
    return l1, e1, seam, E0


@pytest.mark.parametrize("name", ["grad_xabs", "grad_sumabs", "grad_norm"])
def test_strip_update_equals_jax_pallas_gather_scatter(name):
    """The port's plain gather -> bands_fn -> scatter against JAX
    `_recompute_strip_pallas` with a plugged energy, whose slab gather (#11)
    and strip scatter (#12) run as Pallas kernels in interpret mode."""
    H, W = 16, 256
    assert jcarve.strip_pallas_ok(H, W, 2)
    luma = _rand_luma(H, W, seed=11)
    l1, e1, seam, E0 = _after_one_seam(luma, builtin_energy(name))
    got = e1.clone()
    tcarve.update_energy(l1, got, seam, tcarve.step_params(
        8, 0.0, 1.0, energy_fn=builtin_energy(name)))
    mid = jcarve.make_state(jnp.asarray(luma))._replace(
        luma=jnp.asarray(l1.numpy()), energy=jnp.asarray(E0.numpy()),
        width=jnp.int32(W - 1))
    want = np.asarray(jcarve._recompute_strip_pallas(
        mid, jnp.asarray(seam.numpy()), 2, 0.0, 1.0, 1,
        jfn.builtin_energy(name)))
    live = W - 1
    np.testing.assert_array_equal(got[:, :live].numpy(), want[:, :live])
    np.testing.assert_array_equal(
        got[:, :live].numpy(),
        oracle.gradient_energy_map(l1[:, :live].numpy(), name))


@pytest.mark.parametrize("n,delta_x", [(2, 1), (4, 1), (6, 1), (2, 2)])
def test_strip_gather_reads_each_rows_band(n, delta_x):
    rng = np.random.default_rng(n)
    luma = torch.from_numpy(rng.random((2, 12, 40), dtype=np.float32))
    seam = torch.from_numpy(rng.integers(0, 40, (2, 12)).astype(np.int32))
    kernels.reset_launches()
    bands = strip_gather(luma, seam, n, delta_x=delta_x)
    half, strip_w = tstrip._strip_extent(n, delta_x)
    assert bands.shape == (2, 12, n, strip_w + n - 1)
    full = rows_to_bands(luma, n)  # (2, 12, n, 40 + n - 1)
    for b in range(2):
        for i in range(12):
            s = min(max(int(seam[b, i]) - half, 0), 40 - strip_w)
            np.testing.assert_array_equal(
                bands[b, i].numpy(), full[b, i, :, s:s + strip_w + n - 1])
    # the scatter writes each strip back at the same start
    energy = torch.zeros((2, 12, 40))
    strip = torch.arange(1, 2 * 12 * strip_w + 1,
                         dtype=torch.float32).reshape(2, 12, strip_w)
    strip_scatter(energy, strip, seam, n, delta_x=delta_x)
    for b in range(2):
        for i in range(12):
            s = min(max(int(seam[b, i]) - half, 0), 40 - strip_w)
            np.testing.assert_array_equal(energy[b, i, s:s + strip_w].numpy(),
                                          strip[b, i].numpy())
            assert int((energy[b, i] != 0).sum()) == strip_w
    assert sum(kernels.launch_counts().values()) == 0


def test_strip_wrappers_reject_bad_shapes():
    luma = torch.zeros((8, 7))
    seam = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="does not fit"):
        strip_gather(luma, seam, 2)
    with pytest.raises(ValueError, match="strip"):
        strip_scatter(torch.zeros((8, 20)), torch.zeros((8, 7)), seam, 2)
    with pytest.raises(ValueError, match="bands"):
        band_energy(torch.zeros((4, 3, 9)), 2, 0.0, 1.0)
    with pytest.raises(ValueError, match="blocksize"):
        band_energy(torch.zeros((4, 6, 9)), 6, 0.0, 1.0)


@pytest.mark.parametrize("stack", [False, True], ids=["plane", "stack"])
@pytest.mark.parametrize("delta_x", [1, 2, 4])
@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_band_energy_plain_equals_eager_jax(n, delta_x, stack):
    """`band_energy`'s plain version on gathered bands against eager JAX
    `energy_from_bands` on the same bands, bit for bit; and the DCT strip
    as gather -> band_energy -> scatter equals a full recompute.  The bands
    are those of a (24, 96) plane, or with `stack` of a (2, 24, 96) stack
    of images with their own seams ((B, H, n, C) bands, as (B*H, n, C) for
    JAX), gathered for the strip of `delta_x`: C = 9 .. 99 columns, the
    geometries that chip_smoke.py phase 4a holds the kernel to."""
    rng = np.random.default_rng([n, delta_x, int(stack)])
    B = 2 if stack else 1
    luma = rng.random((B, 24, 96), dtype=np.float32)
    seams = np.clip(np.cumsum(rng.integers(-delta_x, delta_x + 1, (B, 24)),
                              axis=-1) + 40, 0, 95).astype(np.int32)
    t = torch.from_numpy(luma if stack else luma[0])
    seam = torch.from_numpy(seams if stack else seams[0])
    bands = strip_gather(t, seam, n, delta_x=delta_x)
    half, strip_w = tstrip._strip_extent(n, delta_x)
    assert bands.shape == (*seam.shape, n, strip_w + n - 1)
    got = band_energy(bands, n, 0.3, 0.8)
    want = np.asarray(jdct.energy_from_bands(
        jnp.asarray(bands.numpy().reshape(-1, n, strip_w + n - 1)), n, 0.3,
        0.8))
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    energy = torch.full_like(t, -1.0)
    strip_scatter(energy, got, seam, n, delta_x=delta_x)
    full = energy_from_bands(rows_to_bands(t, n), n, 0.3, 0.8)
    start, _ = tstrip._strip_bounds(seam, n, 96, delta_x)
    for e, f, st in zip(energy.reshape(B, 24, 96), full.reshape(B, 24, 96),
                        start.reshape(B, 24)):
        for i, s in enumerate(st.tolist()):
            np.testing.assert_array_equal(e[i, s:s + strip_w].numpy(),
                                          f[i, s:s + strip_w].numpy())
    assert int((energy >= 0).sum()) == B * 24 * strip_w


# ------------------------------------------------- routes against JAX --

@pytest.mark.parametrize("energy", JAX_EXACT)
@pytest.mark.parametrize("case", [
    dict(seams=-6, output_seams=True, output_energy=True),
    dict(seams=5, output_seams=True),
    dict(seams=-5, vertically=True, output_seams=True, output_energy=True),
    dict(seams=-4, tie="rightmost", resize_canvas=False, output_seams=True),
])
def test_api_carve_with_energy_equals_jax(case, energy, make_image):
    case = dict(case)
    seams = case.pop("seams")
    img = make_image(24, 40, c=3)
    want = japi.carve(img, seams, energy=energy, **case)
    got = tapi.carve(img, seams, energy=energy, device="cpu", **case)
    for field in ("image", "visibility_map", "energy_image"):
        a, b = getattr(got, field), getattr(want, field)
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)


def test_energy_image_uses_the_plugged_energy(make_image):
    img = make_image(20, 30, c=3)
    carver = Carver(img, energy="grad_norm", device="cpu")
    want = JCarver(img, energy="grad_norm").energy_image()
    got = carver.energy_image()
    # u8 of a min-max normalized map: jitted JAX may move a value by an ulp
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # the preview stays the DCT path, as in the JAX package
    np.testing.assert_array_equal(
        carver.energy_preview(),
        Carver(img, device="cpu").energy_preview())
    np.testing.assert_array_equal(carver.energy_preview(),
                                  JCarver(img).energy_preview())


@pytest.mark.parametrize("energy", JAX_EXACT)
def test_batch_route_with_energy_equals_jax(energy, make_image):
    imgs = np.stack([make_image(16, 32, c=3) for _ in range(3)])
    want_out, want_vm = jmesh.carve_batch(imgs, 4, energy=energy)
    kernels.reset_launches()
    got_out, got_vm = tmesh.carve_batch(imgs, 4, energy=energy,
                                        devices=["cpu"])
    assert sum(kernels.launch_counts().values()) == 0
    np.testing.assert_array_equal(got_vm.numpy(), np.asarray(want_vm))
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    want = japi.carve(imgs, -4, parallel="batch", energy=energy,
                      output_energy=True, output_seams=True)
    got = tapi.carve(imgs, -4, parallel="batch", energy=energy,
                     output_energy=True, output_seams=True, device="cpu")
    for field in ("image", "visibility_map", "energy_image"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


def test_batch_route_with_custom_energy_equals_single_images(make_image):
    fn, _ = _custom("absdev")
    imgs = np.stack([make_image(16, 32, c=3) for _ in range(3)])
    res = tapi.carve(imgs, -4, parallel="batch", energy=fn,
                     output_seams=True, device="cpu")
    for b in range(3):
        one = tapi.carve(imgs[b], -4, energy=fn, output_seams=True,
                         device="cpu")
        np.testing.assert_array_equal(res.visibility_map[b],
                                      one.visibility_map)
        np.testing.assert_array_equal(res.image[b], one.image)


# ---------------------------------------------------------- checkpoints --

class _Interrupt(Exception):
    pass


class _StopAtEnd:
    """A Progress that interrupts the carve at its last chunk, before that
    chunk is written: the checkpoint then holds the chunk before."""

    def init(self, message):
        pass

    def update(self, fraction):
        if fraction == 1.0:
            raise _Interrupt

    def end(self):
        pass


def _interrupted(carve_resumable, luma, cfg, path):
    with pytest.raises(_Interrupt):
        carve_resumable(luma, 6, cfg, checkpoint_path=path,
                        checkpoint_every=3, progress=_StopAtEnd(),
                        **({"device": "cpu"} if carve_resumable is
                           tckpt.carve_resumable else {}))


@pytest.mark.parametrize("energy", ["grad_sumabs", None])
def test_jax_checkpoint_resumes_in_port(energy, tmp_path):
    luma = _rand_luma(24, 40, seed=30)
    path = str(tmp_path / "jax.npz")
    _interrupted(jckpt.carve_resumable, luma, JConfig(energy=energy), path)
    state, cfg, done, total = tckpt.load_state(path, device="cpu")
    assert (done, total, state.width) == (3, 6, 37)
    assert cfg.energy == energy and cfg == CarverConfig(energy=energy)
    got = tckpt.carve_resumable(None, 6, CarverConfig(), resume_from=path,
                                device="cpu")
    whole = tcarve.carve_n_seams(torch.from_numpy(luma), 6, 8, 0.0, 1.0,
                                 energy_fn=resolve_energy(energy))
    np.testing.assert_array_equal(got.vmap.numpy(), whole.vmap.numpy())
    np.testing.assert_array_equal(got.luma.numpy(), whole.luma.numpy())


@pytest.mark.parametrize("energy", ["grad_sumabs", None])
def test_port_checkpoint_resumes_in_jax(energy, tmp_path):
    luma = _rand_luma(24, 40, seed=31)
    path = str(tmp_path / "port.npz")
    _interrupted(tckpt.carve_resumable, torch.from_numpy(luma),
                 CarverConfig(energy=energy), path)
    with np.load(path) as z:
        assert sorted(z.files) == ["energy", "luma", "meta", "origcol",
                                   "vmap", "width"]
        assert z["width"].dtype == np.int32 and z["width"].shape == ()
    got = jckpt.carve_resumable(None, 6, JConfig(), resume_from=path)
    whole = jckpt.carve_resumable(luma, 6, JConfig(energy=energy))
    np.testing.assert_array_equal(np.asarray(got.vmap),
                                  np.asarray(whole.vmap))


def test_carve_resumable_chunks_and_progress(tmp_path):
    events = []

    class Rec:
        def init(self, m):
            events.append(("init", m))

        def update(self, f):
            events.append(("update", f))

        def end(self):
            events.append(("end",))

    luma = torch.from_numpy(_rand_luma(20, 36, seed=32))
    cfg = CarverConfig(energy="grad_norm")
    path = str(tmp_path / "ck.npz")
    got = tckpt.carve_resumable(luma, 7, cfg, checkpoint_path=path,
                                checkpoint_every=3, progress=Rec(),
                                device="cpu")
    assert events == [("init", "Resizing width..."), ("update", 3 / 7),
                      ("update", 6 / 7), ("update", 1.0), ("end",)]
    whole = tcarve.carve_n_seams(luma, 7, 8, 0.0, 1.0, energy_fn=GRAD_NORM)
    np.testing.assert_array_equal(got.vmap.numpy(), whole.vmap.numpy())
    assert tckpt.load_state(path, device="cpu")[2:] == (7, 7)
    with pytest.raises(ValueError, match="requested"):
        tckpt.carve_resumable(None, 8, cfg, resume_from=path,
                              device="cpu")
    custom = CarverConfig(energy=custom_energy(1, lambda w: w[0, 0]))
    with pytest.raises(ValueError, match="checkpoint"):
        tckpt.save_state(str(tmp_path / "bad.npz"),
                         tcarve.make_state(luma), custom, 0, 1)
    # a builtin passed as the object is stored by its name
    tckpt.save_state(path, tcarve.make_state(luma),
                     CarverConfig(energy=ENERGY_NULL), 0, 1)
    assert tckpt.load_state(path, device="cpu")[1].energy == "null"


def test_carver_progress_and_checkpoint_cover_the_width_pass(tmp_path,
                                                             make_image):
    events = []

    class Rec:
        def init(self, m):
            events.append("init")

        def update(self, f):
            events.append(f)

        def end(self):
            events.append("end")

    img = make_image(20, 30, c=3)
    path = str(tmp_path / "ck.npz")
    res = Carver(img, energy="grad_sumabs", progress=Rec(),
                 checkpoint_path=path, checkpoint_every=2,
                 device="cpu").resize(25, 17)
    assert events == ["init", 0.4, 0.8, 1.0, "end"]  # the width pass only
    want = JCarver(img, energy="grad_sumabs").resize(25, 17)
    np.testing.assert_array_equal(res.image, want.image)
    assert tckpt.load_state(path, device="cpu")[2:] == (5, 5)
