"""The seam step that a CUDA graph captures (`ops/carve.py::SeamSteps`),
run eagerly on the CPU.

The step keeps the logical width and the seam's label on the device, swaps
two buffer sets every seam, and lives in a small cache keyed as the JAX
carve's jit is.  Here its plain versions run: it must give the seams,
luma and energy of the seam loop as it ran before the step (a Python int
width and label, one public wrapper a stage: `_eager_loop` below), and of
the JAX package: vmaps against the native f32 carver (DCT) or the JAX
carve (plugged energies), final energies against eager JAX on the final
luma.  Graphs themselves run only on the card (`chip_smoke.py` phases 2,
3c and 4b); what decides whether a step is captured, the cache's keys and
buffers, and a failed capture's error are held here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dct_carver_tpu.ops import carve as jcarve
from dct_carver_tpu.ops import dct as jdct
from dct_carver_tpu.ops import energy_fn as jfn
from dct_carver_tpu.utils.native import carve_native_f32
from dct_carver_tpu_torch import kernels
from dct_carver_tpu_torch.kernels.apply_kernel import apply_seam
from dct_carver_tpu_torch.kernels.dp_kernel import find_seam, find_seams
from dct_carver_tpu_torch.kernels.strip_kernel import strip_update
from dct_carver_tpu_torch.ops import carve as tcarve
from dct_carver_tpu_torch.ops import strip as tstrip
from dct_carver_tpu_torch.ops.energy_fn import builtin_energy
from dct_carver_tpu_torch.parallel import spatial as tsp
from dct_carver_tpu_torch.utils import checkpoint as tckpt
from dct_carver_tpu_torch.utils import graphs as tgraphs
from dct_carver_tpu_torch.utils.config import CarverConfig

EDGES, TEXTURES = 0.3, 0.7
# (H, W) of each image, and the stack's size (0: a plane)
LAYOUTS = {"plane": (0, 24, 40), "stack": (3, 20, 36),
           "narrow": (0, 16, 7)}  # narrower than every strip


def _luma(layout, seed):
    B, H, W = LAYOUTS[layout]
    shape = (B, H, W) if B else (H, W)
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _eager_loop(luma, n_seams, blocksize, tie, energy_fn):
    """The seam loop before the step: a Python int width and label, each
    stage through its public wrapper (their plain versions on the CPU)."""
    W = luma.shape[-1]
    state = tcarve.make_state(luma.clone())
    energy = tcarve.full_energy_map(state.luma, blocksize, EDGES, TEXTURES,
                                    energy_fn=energy_fn)
    strip = tstrip.strip_fits(W, blocksize, 1, energy_fn)
    lum, origcol, vmap, width = state.luma, state.origcol, state.vmap, W
    for k in range(1, n_seams + 1):
        find = find_seams if energy.ndim == 3 else find_seam
        seam = find(energy, width, tie=tie)
        orig = origcol.gather(-1, seam[..., None].to(torch.int64))
        vmap.scatter_(-1, orig.to(torch.int64), k)
        lum, origcol, energy = apply_seam(lum, origcol, energy, seam, width)
        width -= 1
        if not strip:
            energy = tcarve.full_energy_map(lum, blocksize, EDGES, TEXTURES,
                                            energy_fn=energy_fn)
        elif energy_fn is not None:
            tcarve.update_energy(lum, energy, seam, tcarve.step_params(
                blocksize, EDGES, TEXTURES, energy_fn=energy_fn))
        else:
            strip_update(lum, energy, seam, blocksize, EDGES, TEXTURES)
    return lum, vmap, energy, width


def _jax_reference(luma, n_seams, blocksize, tie, energy):
    """(vmap, final energy on the live columns) of one image from the JAX
    side: the native f32 carver's vmap for the DCT (the JAX carve's own
    jitted multiply-adds may contract), the JAX carve's for a plugged
    energy (elementwise: nothing to contract), each energy eager on the
    JAX carve's final luma."""
    H, W = luma.shape
    live = W - n_seams
    if energy is None:
        vmap = carve_native_f32(luma, n_seams, blocksize, EDGES, TEXTURES,
                                tie=tie)
        jstate = jcarve.carve_n_seams(jnp.asarray(luma), n_seams, blocksize,
                                      EDGES, TEXTURES, use_pallas=False,
                                      tie=tie)
        e = jdct.dct_energy_map(jstate.luma, blocksize, EDGES, TEXTURES)
        return vmap, np.asarray(e)[:, :live]
    fn = jfn.builtin_energy(energy)
    jstate = jcarve.carve_n_seams(jnp.asarray(luma), n_seams, 8, 0.0, 1.0,
                                  use_pallas=False, energy_fn=fn, tie=tie)
    return (np.asarray(jstate.vmap),
            np.asarray(fn.energy_map(jstate.luma))[:, :live])


@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
@pytest.mark.parametrize("energy", [2, 4, 8, "grad_norm"])
@pytest.mark.parametrize("n_seams", [5, 6])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_step_equals_eager_loop_and_jax(layout, n_seams, energy, tie):
    luma_np = _luma(layout, seed=n_seams)
    luma = torch.from_numpy(luma_np)
    blocksize = 8 if energy == "grad_norm" else energy
    energy_fn = builtin_energy(energy) if energy == "grad_norm" else None
    kernels.reset_launches()
    got = tcarve.carve_n_seams(luma, n_seams, blocksize, EDGES, TEXTURES,
                               tie=tie, energy_fn=energy_fn)
    assert sum(kernels.launch_counts().values()) == 0
    lum, vmap, e, width = _eager_loop(luma, n_seams, blocksize, tie,
                                      energy_fn)
    assert got.width == width == luma.shape[-1] - n_seams
    np.testing.assert_array_equal(got.vmap.numpy(), vmap.numpy())
    np.testing.assert_array_equal(got.luma.numpy(), lum.numpy())
    np.testing.assert_array_equal(got.energy.numpy(), e.numpy())
    planes = luma_np if luma_np.ndim == 3 else luma_np[None]
    for b, one in enumerate(planes):
        want_vmap, want_e = _jax_reference(
            one, n_seams, blocksize, tie,
            None if energy_fn is None else energy)
        np.testing.assert_array_equal(got.vmap.reshape(planes.shape)[b]
                                      .numpy(), want_vmap)
        np.testing.assert_array_equal(
            got.energy.reshape(planes.shape)[b, :, :width].numpy(), want_e)


@pytest.mark.parametrize("energy", [None, "grad_norm"])
@pytest.mark.parametrize("every", [3, 5])
def test_resumable_chunks_share_one_step(monkeypatch, tmp_path, energy,
                                         every):
    """carve_resumable's chunks end at odd seams, so a set swap crosses a
    chunk; they run through one step object (on a card: one capture) and
    equal the carve in one go."""
    luma = torch.from_numpy(_luma("plane", seed=every))
    made = []
    init = tcarve.SeamSteps.__init__

    def counted(self, *args, **kwargs):
        made.append(self)
        init(self, *args, **kwargs)

    tcarve.clear_step_cache()
    monkeypatch.setattr(tcarve.SeamSteps, "__init__", counted)
    cfg = CarverConfig(energy=energy, edges=EDGES, textures=TEXTURES)
    got = tckpt.carve_resumable(luma, 11, cfg, checkpoint_every=every,
                                checkpoint_path=str(tmp_path / "ck.npz"),
                                device="cpu")
    assert len(made) == 1
    whole = _eager_loop(luma, 11, 8, "leftmost", cfg.energy_function)
    for a, b in zip((got.luma, got.vmap, got.energy), whole[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert got.width == whole[3]


class _EagerGraphs:
    """A `StepGraphs` stand-in: a capture keeps the step, a replay runs it
    (no graph)."""

    def __init__(self, device, what, counters):
        self.step = None
        self.replays = 0

    @property
    def captured(self):
        return self.step is not None

    def capture(self, step, sources):
        self.step = step

    def replay(self, src):
        self.replays += 1
        self.step(src)


class _Stream:
    """A torch.cuda.Stream stand-in on `device` that logs what it waits
    on."""

    def __init__(self, device=None, log=None):
        self.device = device
        self.log = [] if log is None else log

    def wait_stream(self, other):
        self.log.append((self, other))


@pytest.fixture
def sim_card(monkeypatch):
    """The graphed step's control flow on the CPU: every kernel step counts
    as graphed, a capture keeps the step and a replay runs it, the
    find-seam C entry is its plain version, and the streams are
    stand-ins.  Yields the devices that `torch.cuda.current_stream` was
    asked for and the streams' waits."""
    from dct_carver_tpu_torch.kernels import dp_kernel
    from dct_carver_tpu_torch.ops.dp import find_seam as plain, mask_energy

    asked, waits = [], []
    monkeypatch.setattr(tcarve, "cards_of",
                        lambda devices: list(dict.fromkeys(devices)))
    monkeypatch.setattr(tgraphs, "StepGraphs", _EagerGraphs)
    monkeypatch.setattr(dp_kernel, "_find_seams_cuda", lambda k, e, w, lo,
                        tie: plain(mask_energy(e, w), 1, 0.0, tie)
                        .to(torch.int32))

    def current_stream(device=None):
        asked.append(device)
        return _Stream(device, waits)

    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda device=None: _Stream(device, waits))
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: _Null())
    tcarve.clear_step_cache()
    yield asked, waits
    tcarve.clear_step_cache()


def _spatial_carve(luma, n_seams):
    """The spatial route's seam step over 4 CPU shards of `luma`: (the
    steps, the whole luma, vmap and energy after `n_seams` seams)."""
    H, W = luma.shape
    st, mesh = tsp.spatial_make_state(luma, devices=["cpu"] * 4,
                                      edges=EDGES, textures=TEXTURES)
    steps = tsp._SeamSteps(mesh, st, tsp._params(
        W, H, edges=EDGES, textures=TEXTURES, dead_max=n_seams))
    end = steps.carve(st, 0, n_seams)
    return steps, [mesh.join(x) for x in (end.luma, end.vmap, end.energy)]


@pytest.mark.parametrize("layout", ["plane", "stack", "spatial"])
def test_graphed_step_replays_every_seam_after_the_first(sim_card, layout):
    """On a (simulated) card the first carve of a key runs its first seam
    eagerly and replays the rest; the next carve of the key replays every
    seam.  Both equal the eager loop.  The spatial route's step runs on
    the same runner: its first seam eagerly, the rest replayed, equal to
    the eager loop on the live columns; it keeps no step between carves."""
    if layout == "spatial":
        luma = torch.from_numpy(_luma("plane", seed=4))
        lum, vmap, e, width = _eager_loop(luma, 7, 8, "leftmost", None)
        for _ in range(2):
            steps, got = _spatial_carve(luma, 7)
            assert steps.graph_cards and steps.graphs.replays == 6
            np.testing.assert_array_equal(got[1].numpy(), vmap.numpy())
            for a, b in zip((got[0], got[2]), (lum, e)):
                np.testing.assert_array_equal(a[:, :width].numpy(),
                                              b[:, :width].numpy())
        return
    luma = torch.from_numpy(_luma(layout, seed=4))
    for want in (6, 7):
        got = tcarve.carve_n_seams(luma, 7, 8, EDGES, TEXTURES)
        steps = next(iter(tcarve._CACHE.values()))
        assert steps.graphs.replays == want
        steps.graphs.replays = 0
        lum, vmap, e, width = _eager_loop(luma, 7, 8, "leftmost", None)
        assert got.width == width
        for a, b in zip((got.luma, got.vmap, got.energy), (lum, vmap, e)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_vmap_record_waits_on_the_steps_own_card(sim_card):
    """The vmap record's side stream is ordered against the current stream
    of the card the step runs on, not of whichever card is current: a
    carve on a second card must not race its own find-seam."""
    asked, waits = sim_card
    card = torch.device("cuda", 1)
    luma = torch.from_numpy(_luma("plane", seed=5))
    state = tcarve.make_state(luma.clone())
    state = state._replace(energy=tcarve.full_energy_map(
        state.luma, 8, EDGES, TEXTURES))
    p = tcarve.StepParams(8, EDGES, TEXTURES, True, True, 1, 0.0,
                          "leftmost", None)
    steps = tcarve.SeamSteps(state, p)
    steps.side = _Stream(card, waits)
    asked.clear()
    got = steps.carve(state, 0, 4)
    assert asked and all(d == card for d in asked)
    # each seam: the side waits on the card's stream, then the reverse
    assert len(waits) == 8
    for (a, b), (c, d) in zip(waits[::2], waits[1::2]):
        assert a is steps.side and b.device == card
        assert c is b and d is steps.side
    lum, vmap, e, _ = _eager_loop(luma, 4, 8, "leftmost", None)
    for a, b in zip((got.luma, got.vmap, got.energy), (lum, vmap, e)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_cached_step_hands_back_its_own_tensors(sim_card):
    """Two carves of one key in a row on different inputs: each equals its
    eager loop, and the first carve's result survives the second (nothing
    a carve returns aliases the cache's buffers)."""
    a = torch.from_numpy(_luma("stack", seed=1))
    b = torch.from_numpy(_luma("stack", seed=2))
    first = tcarve.carve_n_seams(a, 5, 8, EDGES, TEXTURES)
    kept = [x.clone() for x in (first.luma, first.vmap, first.energy)]
    second = tcarve.carve_n_seams(b, 5, 8, EDGES, TEXTURES)
    assert len(tcarve._CACHE) == 1
    steps = next(iter(tcarve._CACHE.values()))
    cached = {x.data_ptr() for s in steps.sets for x in s}
    cached.add(steps.vmap.data_ptr())
    for res, luma in ((first, a), (second, b)):
        assert not {x.data_ptr() for x in res[:3] + (res.energy,)} & cached
        lum, vmap, e, _ = _eager_loop(luma, 5, 8, "leftmost", None)
        for got, want in zip((res.luma, res.vmap, res.energy),
                             (lum, vmap, e)):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    for got, want in zip((first.luma, first.vmap, first.energy), kept):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_a_carve_takes_its_step_out_of_the_cache(sim_card):
    """While a carve runs, its step is out of the cache: a second carve of
    the key at the same time (another thread) gets steps of its own, and
    the step goes back when the carve ends."""
    luma = torch.rand(16, 40)
    p = tcarve.StepParams(8, EDGES, TEXTURES, True, True, 1, 0.0,
                          "leftmost", None)
    one, two = tcarve._take_steps(luma, p), tcarve._take_steps(luma, p)
    assert one is not two and not tcarve._CACHE
    tcarve.carve_n_seams(luma, 2, 8, EDGES, TEXTURES)
    assert len(tcarve._CACHE) == 1
    steps = next(iter(tcarve._CACHE.values()))
    assert tcarve._take_steps(luma, p) is steps and not tcarve._CACHE


def test_cache_keeps_the_last_keys_and_skips_large_sets(sim_card,
                                                        monkeypatch):
    for w in (40, 41, 42):
        tcarve.carve_n_seams(torch.rand(8, w), 2, 8, EDGES, TEXTURES)
    assert [k[1] for k in tcarve._CACHE] == [(8, 41), (8, 42)]
    tcarve.carve_n_seams(torch.rand(8, 41), 2, 8, EDGES, TEXTURES)
    assert [k[1] for k in tcarve._CACHE] == [(8, 42), (8, 41)]
    monkeypatch.setattr(tcarve, "CACHE_MAX_BYTES", 0)
    luma = torch.from_numpy(_luma("plane", seed=3))
    got = tcarve.carve_n_seams(luma, 4, 8, EDGES, TEXTURES)
    assert [k[1] for k in tcarve._CACHE] == [(8, 42), (8, 41)]
    lum, vmap, e, _ = _eager_loop(luma, 4, 8, "leftmost", None)
    for a, b in zip((got.luma, got.vmap, got.energy), (lum, vmap, e)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_step_key_tells_knobs_apart():
    base = tcarve.StepParams(8, EDGES, TEXTURES, True, True, 1, 0.0,
                             "leftmost", None)
    luma = torch.zeros((4, 24, 40))
    key = tcarve.step_key(luma, base)
    assert tcarve.step_key(torch.ones((4, 24, 40)), base) == key
    others = [tcarve.step_key(torch.zeros((4, 24, 41)), base),
              tcarve.step_key(torch.zeros((3, 24, 40)), base),
              tcarve.step_key(luma.double(), base)]
    for change in (dict(edges=0.31), dict(textures=0.71),
                   dict(blocksize=4), dict(tie="rightmost"),
                   dict(strip_update=False), dict(use_pallas=False),
                   dict(energy_fn=builtin_energy("grad_norm")),
                   dict(energy_fn=builtin_energy("grad_xabs"))):
        others.append(tcarve.step_key(luma, base._replace(**change)))
    assert len({key, *others}) == len(others) + 1


def test_only_kernel_steps_on_a_card_are_graphed(monkeypatch):
    """CPU tensors, use_pallas=False and the plain scan DP never capture;
    a CPU carve runs with every graph call made to fail, and keeps nothing
    in the step cache."""
    p = tcarve.StepParams(8, EDGES, TEXTURES, True, True, 1, 0.0,
                          "leftmost", None)
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert tcarve.graphed(card, p)
    assert not tcarve.graphed(card, p._replace(use_pallas=False))
    assert not tcarve.graphed(card, p._replace(delta_x=2))
    assert not tcarve.graphed(card, p._replace(rigidity=0.5))
    assert not tcarve.graphed(cpu, p)

    def fail(*args, **kwargs):
        raise AssertionError("a CPU carve tried a CUDA graph")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", fail)
    monkeypatch.setattr(tgraphs.StepGraphs, "capture", fail)
    monkeypatch.setattr(tgraphs.StepGraphs, "replay", fail)
    tcarve.clear_step_cache()
    for use_pallas in (True, False):
        tcarve.carve_n_seams(torch.rand(16, 40), 4, 8, EDGES, TEXTURES,
                             use_pallas=use_pallas)
    assert not tcarve._CACHE  # a step that captures nothing is not kept


class _FakeGraph:
    """A torch.cuda.CUDAGraph stand-in whose capture or replay fails."""
    fail_capture = False

    def capture_begin(self, pool=None):
        if self.fail_capture:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    def capture_end(self):
        pass

    def replay(self):
        raise RuntimeError("an illegal memory access was encountered")


@pytest.mark.parametrize("where", ["capture", "step", "replay"])
def test_failed_capture_or_replay_raises(monkeypatch, where):
    """A capture that fails, in the graph or in the step, and a replay that
    fails raise naming the step; the counters stay as they were, and a
    failed capture keeps no graph to replay."""
    monkeypatch.setattr(_FakeGraph, "fail_capture", where == "capture")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda *a: type("S", (), {"wait_stream":
                                                  lambda s, o: None})())
    monkeypatch.setattr(torch.cuda, "current_stream", torch.cuda.Stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: _Null())
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())

    class Counter:
        launches = 0

    def step(src):
        Counter.launches += 3
        if where == "step":
            raise RuntimeError("bool() of a tensor waits for the device")

    g = tgraphs.StepGraphs([torch.device("cpu")], "seam step (energy 'dct')",
                           [(Counter, "launches")])
    if where == "replay":
        g.capture(step, (0, 1))
        assert Counter.launches == 0
        with pytest.raises(RuntimeError, match="seam step.*replay failed"):
            g.replay(0)
    else:
        with pytest.raises(RuntimeError,
                           match=r"seam step \(energy 'dct'\): its CUDA "
                                 "graph capture failed"):
            g.capture(step, (0, 1))
        assert not g.captured  # a failed capture keeps no graph
    assert Counter.launches == 0


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Card:
    """Stand-ins for the `torch.cuda` calls a capture and a replay over
    several cards make, logging each: every card's current stream, side
    streams, events, memory pools and graphs."""

    def __init__(self, cards):
        self.log = []
        self.current = {d: self.Stream(self, d, f"main {d}") for d in cards}
        card = self

        class Graph:
            def capture_begin(self, pool=None):
                card.log.append(("begin", pool))

            def capture_end(self):
                card.log.append(("end",))

            def replay(self):
                card.log.append(("replay",))

        class Event:
            def record(self, stream):
                self.stream = stream
                card.log.append(("record", stream.name))

            def query(self):
                return card.done

        class MemPool:
            def __init__(self):
                self.device = card.device
                card.log.append(("pool", self.device))

        self.Graph, self.Event, self.MemPool = Graph, Event, MemPool
        self.device = None
        self.done = False  # whether every event recorded so far completed

    class Stream:
        def __init__(self, card, device, name=None):
            self.card, self.device = card, torch.device(device)
            self.name = name or f"side {self.device}"

        def wait_stream(self, other):
            self.card.log.append(("wait", self.name, other.name))

        def wait_event(self, event):
            self.card.log.append(("wait", self.name, event.stream.name))

    def patch(self, monkeypatch):
        import contextlib

        card = self

        @contextlib.contextmanager
        def stream(s):
            before = card.current[s.device]
            card.current[s.device] = s
            yield
            card.current[s.device] = before

        @contextlib.contextmanager
        def device(d):
            before, card.device = card.device, torch.device(d)
            yield
            card.device = before

        @contextlib.contextmanager
        def use_mem_pool(pool, d):
            assert pool.device == torch.device(d)
            card.log.append(("use pool", torch.device(d)))
            yield
            card.log.append(("pool done", torch.device(d)))

        monkeypatch.setattr(torch.cuda, "CUDAGraph", self.Graph)
        monkeypatch.setattr(torch.cuda, "Event", self.Event)
        monkeypatch.setattr(torch.cuda, "MemPool", self.MemPool)
        monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
        monkeypatch.setattr(torch.cuda, "Stream",
                            lambda d: self.Stream(self, d))
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda d: self.current[torch.device(d)])
        monkeypatch.setattr(torch.cuda, "stream", stream)
        monkeypatch.setattr(torch.cuda, "device", device)
        monkeypatch.setattr(torch.cuda, "use_mem_pool", use_mem_pool)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: (
            pytest.fail("a capture or a replay waited for a card")))


def test_one_graph_over_several_cards(monkeypatch):
    """A step over three cards of one process is captured as one graph a
    source on the first card: every other card's side stream is forked
    from the capturing stream inside the capture and joined back before
    it ends, is that card's current stream while the step runs, and
    allocates from a pool made on that card, one pool a card for both
    graphs.  A replay waits for the work queued on every card, and every
    card's stream waits for the replay.  When the object goes, its pools
    are kept until an event a card after its last replay has completed.
    Nothing waits for a card."""
    cards = [torch.device("cuda", i) for i in (0, 2, 1)]
    fake = _Card(cards)
    fake.patch(monkeypatch)
    monkeypatch.setattr(tgraphs, "_RETIRED", [])

    class Counter:
        launches = 0

    seen = []

    def step(src):
        seen.append({d.index: fake.current[d].name for d in cards})
        Counter.launches += 5

    g = tgraphs.StepGraphs(cards, "spatial seam step", [(Counter, "launches")])
    g.capture(step, (0, 1))
    sides = {"side cuda:0", "side cuda:1", "side cuda:2"}
    assert seen == [{0: "side cuda:0", 2: "side cuda:2", 1: "side cuda:1"}] * 2
    assert Counter.launches == 0
    log = fake.log
    assert [e for e in log if e[0] == "pool"] == [("pool", cards[1]),
                                                 ("pool", cards[2])]
    for graph in range(2):  # each capture, between its begin and its end
        begin = [i for i, e in enumerate(log) if e[0] == "begin"][graph]
        end = [i for i, e in enumerate(log) if e[0] == "end"][graph]
        inside = log[begin + 1:end]
        before = log[:begin]
        # every side stream starts after its card's queued work
        for d in cards:
            assert ("wait", f"side {d}", f"main {d}") in before
        forks = [e for e in inside if e[:2] != ("wait", "side cuda:0")
                 and e[0] == "wait"]
        joins = [e for e in inside if e[:2] == ("wait", "side cuda:0")]
        assert forks == [("wait", "side cuda:2", "side cuda:0"),
                         ("wait", "side cuda:1", "side cuda:0")]
        assert joins == [("wait", "side cuda:0", "side cuda:2"),
                         ("wait", "side cuda:0", "side cuda:1")]
        assert [e for e in inside if e[0] == "use pool"] == [
            ("use pool", cards[1]), ("use pool", cards[2])]
        assert {e[2] for e in joins} | {"side cuda:0"} == sides
    fake.log.clear()
    g.replay(1)
    assert Counter.launches == 5
    assert fake.log == [
        ("record", "main cuda:2"), ("wait", "main cuda:0", "main cuda:2"),
        ("record", "main cuda:1"), ("wait", "main cuda:0", "main cuda:1"),
        ("replay",), ("record", "main cuda:0"),
        ("wait", "main cuda:2", "main cuda:0"),
        ("wait", "main cuda:1", "main cuda:0")]
    pools = g.pools
    fake.log.clear()
    del g
    assert fake.log == [("record", f"main {d}") for d in cards]
    assert [r[1] for r in tgraphs._RETIRED] == [pools]
    tgraphs._release_retired()  # the replays still run: kept
    assert len(tgraphs._RETIRED) == 1
    fake.done = True
    tgraphs._release_retired()
    assert not tgraphs._RETIRED
