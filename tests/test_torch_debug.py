"""The port's debug modes and profiling (`dct_carver_tpu_torch/utils/
debug.py`, `utils/profiling.py`) on the CPU.

`debug_mode` is held against the JAX package's: a NaN from an op raises
`FloatingPointError`, carves inside it equal carves outside it (and the
JAX package's, on the structured corpus of tests/test_native.py), and
`check_finite` agrees with JAX's on the same states.  The switch that
makes every seam step eager is held where the graphs would be: a
simulated card (the kernels' DP through its plain version) that captures
nothing inside `debug_mode`.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_carver_tpu.ops import carve as jcarve
from dct_carver_tpu.utils import debug as jdebug
from dct_carver_tpu.utils.native import carve_native_f32
from dct_carver_tpu_torch import api as tapi
from dct_carver_tpu_torch.kernels import dp_kernel
from dct_carver_tpu_torch.ops import carve as tcarve
from dct_carver_tpu_torch.ops.dp import find_seam as plain_find, mask_energy
from dct_carver_tpu_torch.parallel import spatial as tspatial
from dct_carver_tpu_torch.utils import debug as tdebug
from dct_carver_tpu_torch.utils import graphs as tgraphs
from dct_carver_tpu_torch.utils import profiling as tprof

from test_native import _structured_luma

EDGES, TEXTURES = 0.3, 0.7
P = tcarve.StepParams(8, EDGES, TEXTURES, True, True, 1, 0.0, "leftmost",
                      None)


def test_nan_from_an_op_raises():
    x = torch.zeros(4)
    with tdebug.debug_mode():
        with pytest.raises(FloatingPointError, match="nan"):
            x / x
        with pytest.raises(FloatingPointError, match="nan"):
            x.clone().div_(x)  # in place
        assert torch.isinf(torch.ones(2) / x[:2]).all()  # inf is no NaN
        torch.empty(1000).fill_(1.0)  # uninitialised memory is not checked
    assert torch.isnan(x / x).all()  # outside: no check
    with tdebug.debug_mode(nan_checks=False, disable_jit=True):
        assert torch.isnan(x / x).all()
    # the JAX package's debug mode raises on the same op
    with jdebug.debug_mode():
        with pytest.raises(FloatingPointError):
            jnp.zeros(4) / jnp.zeros(4)


def test_switches_are_scoped_and_per_thread():
    card = torch.device("cuda")
    assert tcarve.graphed(card, P)
    seen = {}
    for kw in ({}, {"disable_jit": True}, {"nan_checks": False,
                                           "disable_jit": True}):
        with tdebug.debug_mode(**kw):
            assert not tcarve.graphed(card, P)
            assert tcarve.kernel_dp(card, P)
            assert tdebug.checks_nans() == kw.get("nan_checks", True)
            with tdebug.debug_mode(nan_checks=False):  # nested: still eager
                assert not tcarve.graphed(card, P)
            assert not tcarve.graphed(card, P)
            t = threading.Thread(target=lambda: seen.update(
                other=tcarve.graphed(card, P)))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive() and seen["other"]
        assert tcarve.graphed(card, P) and not tdebug.checks_nans()
    assert not tdebug.eager_steps()


@pytest.mark.parametrize("layout", ["plane", "stack"])
def test_carve_in_debug_mode_checks_every_seam(layout, monkeypatch):
    """A carve inside debug_mode equals one outside it and the native f32
    carver, and its loop checks the state after every seam."""
    shape = (3, 20, 36) if layout == "stack" else (24, 40)
    luma = np.random.default_rng(2).random(shape, dtype=np.float32)
    want = tcarve.carve_n_seams(torch.from_numpy(luma), 6, 8, EDGES,
                                TEXTURES)
    widths = []

    def check(state, where=""):
        widths.append((state.width, where))
        tdebug.check_finite(state, where)

    monkeypatch.setattr(tcarve, "check_finite", check)
    with tdebug.debug_mode():
        got = tcarve.carve_n_seams(torch.from_numpy(luma), 6, 8, EDGES,
                                   TEXTURES)
    W = shape[-1]
    assert widths == [(W - k, f"after seam {k}") for k in range(1, 7)]
    for a, b in zip((got.luma, got.vmap, got.energy),
                    (want.luma, want.vmap, want.energy)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    planes = luma if layout == "stack" else luma[None]
    for plane, vm in zip(planes, got.vmap.reshape(-1, *shape[-2:])):
        np.testing.assert_array_equal(
            vm.numpy(), carve_native_f32(plane, 6, 8, EDGES, TEXTURES))


def test_debug_carve_equals_jax_debug_carve():
    """Both packages' carves inside their debug modes, on the structured
    corpus.  JAX's runs jitted: its `disable_jit=True` cannot run
    `carve_n_seams` (ROADMAP Queue 3)."""
    luma = _structured_luma("photo", 16, 28)
    with tdebug.debug_mode(disable_jit=True):
        got = tcarve.carve_n_seams(torch.from_numpy(luma), 3, 4, EDGES,
                                   TEXTURES)
    with jdebug.debug_mode():
        want = jcarve.carve_n_seams(jnp.asarray(luma), 3, 4, EDGES, TEXTURES,
                                    use_pallas=False)
        jdebug.check_finite(want, "jax")
    np.testing.assert_array_equal(got.vmap.numpy(), np.asarray(want.vmap))
    tdebug.check_finite(got, "port")


def test_eager_steps_keep_the_kernels_and_capture_nothing(monkeypatch):
    """On a simulated card (every kernel step counts as one, the find-seam
    C entry is its plain version) a carve inside debug_mode runs every
    seam through the kernels' DP, eagerly: no graph is made and the step
    cache stays empty."""
    calls = []

    def find(kernel, e, width, lo, tie):
        calls.append(kernel.name)
        return plain_find(mask_energy(e, width), 1, 0.0, tie).to(torch.int32)

    def no_graphs(*args, **kwargs):
        raise AssertionError("a step inside debug_mode made CUDA graphs")

    monkeypatch.setattr(tcarve, "kernel_dp", lambda device, p: (
        p.use_pallas and p.delta_x == 1 and p.rigidity == 0.0))
    monkeypatch.setattr(dp_kernel, "_find_seams_cuda", find)
    monkeypatch.setattr(tgraphs, "StepGraphs", no_graphs)
    tcarve.clear_step_cache()
    luma = torch.from_numpy(_structured_luma("edges", 20, 32))
    for kw in ({"disable_jit": True}, {}):
        calls.clear()
        with tdebug.debug_mode(**kw):
            got = tcarve.carve_n_seams(luma, 5, 8, EDGES, TEXTURES)
        assert calls == ["find_seam"] * 5
        assert not tcarve._CACHE
        np.testing.assert_array_equal(
            got.vmap.numpy(),
            carve_native_f32(luma.numpy(), 5, 8, EDGES, TEXTURES))


def test_spatial_carve_in_debug_mode(monkeypatch):
    luma = np.random.default_rng(5).random((16, 32), dtype=np.float32)
    want = tspatial.spatial_carve_n_seams(luma, 4, devices=["cpu"] * 2)
    seen = []

    def check(state, where=""):
        seen.append((state.width, tuple(state.energy.shape)))
        tdebug.check_finite(state, where)

    monkeypatch.setattr(tspatial, "check_finite", check)
    with tdebug.debug_mode():
        got = tspatial.spatial_carve_n_seams(luma, 4, devices=["cpu"] * 2)
    assert seen == [(32 - k, (16, 32)) for k in range(1, 5)]
    np.testing.assert_array_equal(got.vmap.numpy(), want.vmap.numpy())
    with tdebug.debug_mode():  # and through the public API
        res = tapi.carve((luma * 255).astype(np.uint8), -3,
                         parallel="spatial", devices=["cpu"] * 2)
    assert res.image.shape == (16, 29)


def test_check_finite_agrees_with_jax():
    luma = _structured_luma("gradient", 16, 24)
    state = tcarve.carve_n_seams(torch.from_numpy(luma), 4, 8, EDGES,
                                 TEXTURES)
    live = state.width
    cases = [("energy", (3, 2), np.nan, "non-finite energy"),
             ("luma", (0, live - 1), np.inf, "non-finite luma"),
             ("energy", (5, live), np.nan, None),    # dead columns
             ("luma", (7, 23), -np.inf, None)]
    for field, (i, j), value, err in cases:
        planes = {f: getattr(state, f).clone() for f in ("energy", "luma")}
        planes[field][i, j] = value
        t = state._replace(**planes)
        j_state = jcarve.CarveState(
            jnp.asarray(planes["luma"].numpy()), None, None,
            jnp.int32(live), jnp.asarray(planes["energy"].numpy()))
        for check, s in ((tdebug.check_finite, t),
                         (jdebug.check_finite, j_state)):
            if err is None:
                check(s, "here")
            else:
                with pytest.raises(FloatingPointError, match=err):
                    check(s, "here")


def test_check_finite_on_a_stack():
    """Each image of a (B, H, W) stack is checked over its own width."""
    energy = torch.zeros(2, 3, 8)
    energy[1, 0, 5] = float("nan")
    luma = torch.zeros(2, 3, 8)
    state = tcarve.CarveState(luma, None, None, 6, energy)
    with pytest.raises(FloatingPointError, match="energy"):
        tdebug.check_finite(state)
    tdebug.check_finite(state._replace(width=torch.tensor([8, 5])))
    with pytest.raises(FloatingPointError):
        tdebug.check_finite(state._replace(width=torch.tensor([5, 6])))
    tdebug.check_finite(state._replace(width=5))


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with tprof.trace(str(log_dir)) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    (name,) = os.listdir(log_dir)
    assert name.endswith(".pt.trace.json")
    with open(log_dir / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert any("matmul" in e.key for e in prof.key_averages())


def test_profile_carve_equals_carve(tmp_path, monkeypatch):
    luma = _structured_luma("photo", 20, 32)
    got = tprof.profile_carve(luma, 5, 4, log_dir=str(tmp_path),
                              device="cpu")
    want = tcarve.carve_n_seams(torch.from_numpy(luma), 5, 4, 0.0, 1.0)
    for a, b in zip((got.luma, got.vmap, got.energy),
                    (want.luma, want.vmap, want.energy)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert got.width == want.width == 27
    assert len(os.listdir(tmp_path)) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprof.profile_carve(luma, 2, log_dir=str(tmp_path))
